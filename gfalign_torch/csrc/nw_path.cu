// NW path-alignment scores for Hopper (sm_90a): the two kernels of the
// search/evalPath scorer, built by gfalign_torch/ops/cuda_build.py with nvcc
// into a shared library with a plain C interface and loaded with ctypes by
// gfalign_torch/ops/nw_cuda.py.
//
//   nw_fwd_packed (K1) replaces gfalign_tpu/ops/nw_pallas.py
//                      _kernel_factory_packed (used when n + m < 8192);
//   nw_fwd_split  (K2) replaces gfalign_tpu/ops/nw_pallas.py
//                      _kernel_factory (used when n + m >= 8192).
//
// Both compute, for every (candidate c, read row r), the reference's
// traceback-recomputed score
//     dp[a_len][b_len] + (E <= a_len ? E : 0)
// where E is the column at which the traceback walk leaves the interior
// (ops/nw_path.py _forward_exit_scores has the proof), with match 0,
// mismatch -1, gap -1, row 0 = -j for j <= a_len else 0, column 0 = 0, and
// free vertical moves in columns j >= b_len.
//
// The read operand.  Both kernels take the reads as nw_cuda.ReadOperand
// prepares them once per read batch: rows sorted by length, longest first,
// padded to a multiple of 128 rows; one (m, Rp) plane of transposed keys
// per orientation (forward, and reverse-complement when the caller wants
// max(forward, reverse-complement)), so that neighbouring threads load
// neighbouring words; and one strip width per block of 128 rows, from that
// block's longest read.  Scores come out in the operand's row order.
//
// K1 design: a thread keeps its read and loops over candidates.  One
// thread owns one read row, both orientations, and runs the ROW recurrence
// with j serial inside the thread, so the horizontal dependency needs no
// scan.  A block is 128 reads of one length bucket x a chunk of candidates:
// the chunk's keys are staged once in shared memory (every thread reads
// the same word, a broadcast) and the thread sweeps them one after another,
// its read keys, free-column deltas and both dp rows in registers.  The
// strip width W is the block's own (even widths 2..16, an instance each,
// chosen by a block-uniform switch), so work follows the live columns, not
// the padded width.  The two orientations are two independent dependency
// chains in one thread, and max(forward, reverse) is written directly.
// Rows longer than 16 take the wide kernel: strips of 32 columns, each
// strip handing its last column to the next through a global scratch plane
// laid out [candidate chunk][orientation][row i][thread] (coalesced); a
// thread reuses its scratch column for every candidate of its chunk, so the
// plane is chunks x rows x n words, not candidates x rows x n.
//
// K1 packs dp, the walk's move priority and E into one int32,
//     ((dp + OFF) << S) | (prio << E_BITS) | E,
// so that one max selects the dp value first, then the walk's priority
// (diagonal 3 > up 2 > left 1; up drops to 0 in a free column, where the
// reference compares RAW predecessors and so prefers left on a tie), with
// E riding along in the low bits.  A cell is a key compare, a select, an
// add, two add-then-max (Hopper's DPX VIADDMNMX, through __viaddmax_s32)
// and the priority mask.  The bit budget needs
// S + bit_length(OFF + 1) < 31; the launcher refuses shapes beyond it,
// which is why K2 carries dp and E as separate words.
//
// K2 design: a pair is shared by many threads.  One block owns one
// (candidate, read row, orientation) and spreads the read's columns over
// its T threads, K columns each, dp row and E row in registers.  Threads
// run a skewed wavefront: lane l of a warp works on row s - l at step s and
// takes its left boundary (dp and E of the neighbour's last column) by
// __shfl_up_sync.  Between warps the boundary goes through a ring of 128
// rows in shared memory; warp w runs two batches of 32 rows behind warp
// w - 1, so one __syncthreads() per 32 rows orders every hand-over.
// Candidate keys stream through a second ring in shared memory, 32 rows per
// barrier, so a candidate of any length fits.  A read wider than T x K
// columns is swept in super-strips that hand their last column on through
// two global scratch planes of n words per block.  The launcher picks K
// (4, 8 or 16) and T from the longest read and the number of pairs
// (nw_cuda.split_layout): more columns a thread cost fewer instructions a
// cell, fewer make a step shorter when a pair has an SM to itself.
//
// What bounds them: integer ALU instructions.  The inputs and the output
// are a few MB at search shapes, while every DP cell costs a handful of
// int32 instructions, so the bound is useful cells x ALU operations per
// cell / the ALU pipe's rate; chip_smoke.py (OPS_PER_CELL) states the
// count.  K1's row chain (left -> add-max -> mask -> next left) is serial
// inside a thread; latency is hidden by the second orientation and by the
// other resident warps.  K2 is latency-bound by design when pairs are few:
// a step is a shuffle plus K dependent cells, and n + T steps are serial.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_R = 128;  // read rows per K1 block
constexpr int STRIP = 32;     // strip width of the wide kernel
constexpr int RING = 128;     // rows of K2's boundary ring (power of two)

__device__ __forceinline__ int32_t row0_dp(int j, int a_len) {
  return j <= a_len ? -j : 0;  // the row-0 extent quirk: over A's extent
}

// max(a + b, c): one DPX instruction on sm_90
__device__ __forceinline__ int32_t addmax(int32_t a, int32_t b, int32_t c) {
#ifdef GF_NO_DPX
  return max(a + b, c);
#else
  return __viaddmax_s32(a, b, c);
#endif
}

// One thread's read row (NS orientations) against the cc candidates staged
// in shared memory.  keys points at this row's first key of the forward
// plane (column stride Rp, orientation stride plane); out at this row's
// score for the chunk's first candidate (candidate stride Rp); scr at this
// thread's scratch word for (orientation 0, row 1), with row stride srow
// and orientation stride n * srow.
template <int W, int NS, bool STRIPS>
__device__ __forceinline__ void packed_sweep(
    const int32_t* a_s, const int32_t* alen_s, int cc, int n,
    const int32_t* __restrict__ keys, size_t plane, int Rp, int b_len,
    int32_t* __restrict__ out, int32_t* scr, size_t srow, int e_bits,
    int off) {
  const int S = e_bits + 2;
  const uint32_t dp1 = 1u << S;  // one dp unit
  const int32_t D_MATCH = (int32_t)(3u << e_bits);
  const int32_t D_MIS = (int32_t)((3u << e_bits) - dp1);
  const int32_t D_VERT = (int32_t)((2u << e_bits) - dp1);
  const int32_t D_HORIZ = (int32_t)((1u << e_bits) - dp1);
  const int32_t NO_PRIO = ~(int32_t)(3u << e_bits);
  const int32_t COL0 = (int32_t)((uint32_t)off << S);  // dp 0, E 0
  const int32_t E_MASK = (1 << e_bits) - 1;
  int32_t bk[NS][W], dv[W];
  auto load_strip = [&](int j0) {
#pragma unroll
    for (int jj = 0; jj < W; ++jj) {
      const int j = j0 + jj + 1;
#pragma unroll
      for (int o = 0; o < NS; ++o)
        bk[o][jj] = j <= b_len ? keys[o * plane + (size_t)(j - 1) * Rp] : -2;
      dv[jj] = j >= b_len ? 0 : D_VERT;  // free vertical: dp 0, prio 0
    }
  };
  if (!STRIPS) load_strip(0);
  const int n_strips = STRIPS ? (b_len + W - 1) / W : 1;
  for (int c = 0; c < cc; ++c) {
    const int a_len = alen_s[c];
    const int32_t* a_row = a_s + (size_t)c * n;
    int32_t fin[NS];
#pragma unroll
    for (int o = 0; o < NS; ++o) fin[o] = COL0;
    for (int s = 0; s < n_strips; ++s) {
      const int j0 = s * W;  // column of the strip's left boundary
      if (STRIPS) load_strip(j0);
      int32_t P[NS][W], lp[NS];
#pragma unroll
      for (int jj = 0; jj < W; ++jj) {
        const int j = j0 + jj + 1;
        const int32_t p =
            (int32_t)((uint32_t)(row0_dp(j, a_len) + off) << S) + j;
#pragma unroll
        for (int o = 0; o < NS; ++o) P[o][jj] = p;
      }
#pragma unroll
      for (int o = 0; o < NS; ++o)
        lp[o] = (int32_t)((uint32_t)(row0_dp(j0, a_len) + off) << S) + j0;
      const bool hand_in = STRIPS && s > 0;
      const bool hand_out = STRIPS && s + 1 < n_strips;
      for (int i = 1; i <= a_len; ++i) {
        const int32_t a = a_row[i - 1];
#pragma unroll
        for (int o = 0; o < NS; ++o) {
          int32_t* sc = scr + ((size_t)o * n + (i - 1)) * srow;
          const int32_t lc = hand_in ? *sc : COL0;
          int32_t dsrc = lp[o], left = lc;
#pragma unroll
          for (int jj = 0; jj < W; ++jj) {
            const int32_t dg = dsrc + (a == bk[o][jj] ? D_MATCH : D_MIS);
            const int32_t t = addmax(P[o][jj], dv[jj], dg);
            const int32_t q = addmax(left, D_HORIZ, t) & NO_PRIO;
            dsrc = P[o][jj];
            P[o][jj] = q;
            left = q;
          }
          lp[o] = lc;
          if (hand_out) *sc = P[o][W - 1];
        }
      }
      if (s + 1 == n_strips) {
        const int jf = b_len - 1 - j0;
#pragma unroll
        for (int jj = 0; jj < W; ++jj)
#pragma unroll
          for (int o = 0; o < NS; ++o)
            if (jj == jf) fin[o] = P[o][jj];
      }
    }
    int32_t best = INT32_MIN;
#pragma unroll
    for (int o = 0; o < NS; ++o) {
      const int dp = (fin[o] >> S) - off;
      const int e = fin[o] & E_MASK;
      best = max(best, dp + (e <= a_len ? e : 0));
    }
    // the score of an empty side is 0
    out[(size_t)c * Rp] = (a_len > 0 && b_len > 0) ? best : 0;
  }
}

// Stage the block's candidate chunk: keys (cc, n), then clamped lengths.
__device__ __forceinline__ int stage_candidates(
    int32_t* a_s, const int32_t* __restrict__ a_keys,
    const int32_t* __restrict__ a_len_arr, int C, int n, int chunk) {
  const int c0 = blockIdx.y * chunk;
  const int cc = min(chunk, C - c0);
  int32_t* alen_s = a_s + (size_t)chunk * n;
  for (int i = threadIdx.x; i < cc * n; i += blockDim.x)
    a_s[i] = a_keys[(size_t)c0 * n + i];
  for (int i = threadIdx.x; i < cc; i += blockDim.x)
    alen_s[i] = min(max(a_len_arr[c0 + i], 0), n);
  __syncthreads();
  return cc;
}

// K1, rows of at most 16 steps: blocks blk0 .. blk0 + gridDim.x - 1 of
// the operand, each with its own strip width block_w (0: only empty rows).
template <int NS>
__global__ void __launch_bounds__(BLOCK_R)
nw_fwd_packed_narrow(const int32_t* __restrict__ a_keys,
                     const int32_t* __restrict__ a_len_arr,
                     const int32_t* __restrict__ keys_t,
                     const int32_t* __restrict__ b_len_arr,
                     const int32_t* __restrict__ block_w,
                     int32_t* __restrict__ out, int C, int n, int Rp, int m,
                     int chunk, int blk0, int e_bits, int off) {
  extern __shared__ int32_t a_s[];
  const int cc = stage_candidates(a_s, a_keys, a_len_arr, C, n, chunk);
  const int32_t* alen_s = a_s + (size_t)chunk * n;
  const int blk = blk0 + blockIdx.x;
  const int row = blk * BLOCK_R + threadIdx.x;
  const int b_len = min(max(b_len_arr[row], 0), m);
  const int32_t* keys = keys_t + row;
  const size_t plane = (size_t)m * Rp;
  int32_t* o = out + (size_t)blockIdx.y * chunk * Rp + row;
#define GF_NARROW(W)                                                        \
  case W:                                                                   \
    packed_sweep<W, NS, false>(a_s, alen_s, cc, n, keys, plane, Rp, b_len,  \
                               o, nullptr, 0, e_bits, off);                 \
    break
  switch (block_w[blk]) {  // block-uniform
    GF_NARROW(2);
    GF_NARROW(4);
    GF_NARROW(6);
    GF_NARROW(8);
    GF_NARROW(10);
    GF_NARROW(12);
    GF_NARROW(14);
    GF_NARROW(16);
    default:  // a block of empty rows
      for (int c = 0; c < cc; ++c) o[(size_t)c * Rp] = 0;
  }
#undef GF_NARROW
}

// K1, rows longer than 16 steps: strips of STRIP columns with the
// scratch hand-over.  scratch holds gridDim.y * NS * n * (gridDim.x * 128)
// words.
template <int NS>
__global__ void __launch_bounds__(BLOCK_R)
nw_fwd_packed_wide(const int32_t* __restrict__ a_keys,
                   const int32_t* __restrict__ a_len_arr,
                   const int32_t* __restrict__ keys_t,
                   const int32_t* __restrict__ b_len_arr,
                   int32_t* __restrict__ out, int32_t* scratch, int C, int n,
                   int Rp, int m, int chunk, int blk0, int e_bits, int off) {
  extern __shared__ int32_t a_s[];
  const int cc = stage_candidates(a_s, a_keys, a_len_arr, C, n, chunk);
  const int32_t* alen_s = a_s + (size_t)chunk * n;
  const int row = (blk0 + blockIdx.x) * BLOCK_R + threadIdx.x;
  const int b_len = min(max(b_len_arr[row], 0), m);
  const size_t srow = (size_t)gridDim.x * BLOCK_R;
  int32_t* scr = scratch + (size_t)blockIdx.y * NS * n * srow +
                 (size_t)blockIdx.x * BLOCK_R + threadIdx.x;
  packed_sweep<STRIP, NS, true>(
      a_s, alen_s, cc, n, keys_t + row, (size_t)m * Rp, Rp, b_len,
      out + (size_t)blockIdx.y * chunk * Rp + row, scr, srow, e_bits, off);
}

// K2: one block per (read row, candidate, orientation); see the header.
// Shared memory: a_ring_size words of candidate keys, then two boundary
// rings (dp, E) of RING rows for each warp.
template <int K>
__global__ void __launch_bounds__(K == 4 ? 1024 : 512)
nw_fwd_split_kernel(const int32_t* __restrict__ a_keys,
                    const int32_t* __restrict__ a_len_arr,
                    const int32_t* __restrict__ keys_t,
                    const int32_t* __restrict__ b_len_arr,
                    int32_t* __restrict__ out, int32_t* scratch, int n, int Rp,
                    int m, int a_ring_size) {
  extern __shared__ int32_t sm[];
  const int r = blockIdx.x, c = blockIdx.y, o = blockIdx.z;
  const int t = threadIdx.x, w = t >> 5, l = t & 31;
  const int T = blockDim.x, NW = T >> 5;
  int32_t* a_ring = sm;
  int32_t* ring_q = sm + a_ring_size;
  int32_t* ring_e = ring_q + NW * RING;
  const int a_len = min(max(a_len_arr[c], 0), n);
  const int b_len = min(max(b_len_arr[r], 0), m);
  const size_t pair = ((size_t)o * gridDim.y + c) * Rp + r;
  if (a_len == 0 || b_len == 0) {  // the score of an empty side is 0
    if (t == 0) out[pair] = 0;
    return;
  }
  const int32_t* keys = keys_t + (size_t)o * m * Rp + r;
  const int32_t* ak = a_keys + (size_t)c * n;
  int32_t* sq = scratch + pair * 2 * n;  // super-strip hand-over: dp, then E
  int32_t* se = sq + n;
  const int amask = a_ring_size - 1;
  const int span = T * K;
  const int n_super = (b_len + span - 1) / span;
  const unsigned FULL = 0xffffffffu;
  for (int ss = 0; ss < n_super; ++ss) {
    const int jbase = ss * span + t * K;  // the column left of this thread's
    const int cols_here = min(b_len - ss * span, span);
    const int nw_used = (cols_here + 32 * K - 1) / (32 * K);
    const int G = 2 * (nw_used - 1) + (a_len + 30) / 32 + 1;
    const bool last_super = ss + 1 == n_super;
    const int jf = b_len - 1 - jbase;  // the score's column, if it is ours
    int32_t bk[K], P[K], PE[K], vg[K];
#pragma unroll
    for (int jj = 0; jj < K; ++jj) {
      const int j = jbase + jj + 1;
      bk[jj] = j <= b_len ? keys[(size_t)(j - 1) * Rp] : -2;
      P[jj] = row0_dp(j, a_len);
      PE[jj] = j;  // a walk reaching row 0 exits at its column
      vg[jj] = j < b_len ? -1 : 0;
    }
    int32_t lp = row0_dp(jbase, a_len), lpe = jbase;
    int32_t last_q = 0, last_e = 0;
    // One wavefront step of this lane: row i of its K columns.  GUARDED
    // steps skip the rows outside 1..a_len (the wavefront's ramps), so a
    // finished lane keeps row a_len in its registers.
    auto step = [&](auto guarded, int i) {
      int32_t in_q = __shfl_up_sync(FULL, last_q, 1);
      int32_t in_e = __shfl_up_sync(FULL, last_e, 1);
      if (decltype(guarded)::value && (i < 1 || i > a_len)) return;
      const int slot = i & (RING - 1);
      if (w > 0) {  // lane 0 takes the previous warp's last column
        const int32_t rq = ring_q[w * RING + slot], re = ring_e[w * RING + slot];
        in_q = l == 0 ? rq : in_q;
        in_e = l == 0 ? re : in_e;
      } else if (ss == 0) {  // column 0: dp 0, exit column 0
        in_q = l == 0 ? 0 : in_q;
        in_e = l == 0 ? 0 : in_e;
      } else if (l == 0) {  // the previous super-strip's last column
        in_q = sq[i - 1];
        in_e = se[i - 1];
      }
      const int32_t a = a_ring[(i - 1) & amask];
      int32_t dsrc = lp, dsrc_e = lpe, left = in_q, left_e = in_e;
#pragma unroll
      for (int jj = 0; jj < K; ++jj) {
        const int32_t up_raw = P[jj];
        const int32_t dg = dsrc + (a == bk[jj] ? 0 : -1);
        // only the add-then-max with `left` is on the serial chain
        const int32_t q = addmax(left, -1, max(dg, up_raw + vg[jj]));
        // the walk's move priority: diagonal, then up when the RAW up
        // predecessor is >= the left one, else left
        const int32_t e =
            q == dg ? dsrc_e : (up_raw >= left ? PE[jj] : left_e);
        dsrc = up_raw;
        dsrc_e = PE[jj];
        P[jj] = q;
        PE[jj] = e;
        left = q;
        left_e = e;
      }
      lp = in_q;
      lpe = in_e;
      last_q = P[K - 1];
      last_e = PE[K - 1];
      if (l == 31) {
        if (w + 1 < nw_used) {
          ring_q[(w + 1) * RING + slot] = last_q;
          ring_e[(w + 1) * RING + slot] = last_e;
        } else if (!last_super && w + 1 == NW) {
          sq[i - 1] = last_q;
          se[i - 1] = last_e;
        }
      }
    };
    for (int g = 0; g < G; ++g) {
      if (t < 32) {  // the next 32 candidate keys
        const int rr = 32 * g + t;
        a_ring[rr & amask] = rr < a_len ? ak[rr] : -1;
      }
      __syncthreads();
      const int sbase = 32 * (g - 2 * w);  // this warp's step at u = 0
      if (w >= nw_used || sbase < 0 || sbase - 30 > a_len) continue;
      const int i0 = sbase - l + 1;  // this lane's row at u = 0
      if (sbase - 30 >= 1 && sbase + 32 <= a_len) {  // every row is live
        for (int u = 0; u < 32; ++u) step(std::false_type{}, i0 + u);
      } else {
        for (int u = 0; u < 32; ++u) step(std::true_type{}, i0 + u);
      }
    }
    // every lane now holds row a_len; one of them holds the score's column
    if (last_super && jf >= 0 && jf < K) {
      int32_t fin_dp = 0, fin_e = 0;
#pragma unroll
      for (int jj = 0; jj < K; ++jj)
        if (jj == jf) {
          fin_dp = P[jj];
          fin_e = PE[jj];
        }
      out[pair] = fin_dp + (fin_e <= a_len ? fin_e : 0);
    }
    __syncthreads();  // the rings and the scratch column are reused
  }
}

int bit_length(int x) {
  int k = 0;
  while (x >> k) ++k;
  return k;
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// K1 on blocks blk0 .. blk0 + nblk - 1 of a prepared read operand.
// a_keys (C, n), a_len (C,), keys_t (ns, m, Rp) transposed read keys per
// orientation, b_len (Rp,) sorted lengths, block_w (Rp / 128,) strip width
// per block, out (C, Rp): all int32 and contiguous.  ns is 1 (forward
// scores) or 2 (max of forward and reverse-complement).  Each block sweeps
// `chunk` candidates.  wide = 0 launches the narrow kernel (every block_w in
// the range is at most 16, scratch unused); wide = 1 the strip kernel, whose
// scratch holds ceil(C / chunk) * ns * n * nblk * 128 int32.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int nw_fwd_packed(const void* a_keys, const void* a_len,
                             const void* keys_t, const void* b_len,
                             const void* block_w, void* out, void* scratch,
                             int C, int n, int Rp, int m, int ns, int blk0,
                             int nblk, int chunk, int wide, void* stream) {
  if (C <= 0 || n <= 0 || Rp <= 0 || Rp % BLOCK_R || m <= 0 || chunk <= 0 ||
      (ns != 1 && ns != 2) || blk0 < 0 || nblk <= 0 ||
      (blk0 + nblk) * BLOCK_R > Rp || (wide && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (C + chunk - 1) / chunk;
  const size_t smem = (size_t)chunk * (n + 1) * sizeof(int32_t);
  if (n_chunks > 65535 || smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const int n_diag = n + m;
  const int e_bits = bit_length(n_diag + 1) > 2 ? bit_length(n_diag + 1) : 2;
  const int off = n_diag + 2;
  if (e_bits + 2 + bit_length(off + 1) >= 31)  // packed-word bit budget
    return (int)cudaErrorInvalidValue;
  const dim3 grid(nblk, n_chunks);
  cudaStream_t st = (cudaStream_t)stream;
  int err;
#define GF_PACKED(NS)                                                        \
  do {                                                                       \
    if (wide) {                                                              \
      if ((err = prepare(nw_fwd_packed_wide<NS>, smem))) return err;         \
      nw_fwd_packed_wide<NS><<<grid, BLOCK_R, smem, st>>>(                   \
          (const int32_t*)a_keys, (const int32_t*)a_len,                     \
          (const int32_t*)keys_t, (const int32_t*)b_len, (int32_t*)out,      \
          (int32_t*)scratch, C, n, Rp, m, chunk, blk0, e_bits, off);         \
    } else {                                                                 \
      if ((err = prepare(nw_fwd_packed_narrow<NS>, smem))) return err;       \
      nw_fwd_packed_narrow<NS><<<grid, BLOCK_R, smem, st>>>(                 \
          (const int32_t*)a_keys, (const int32_t*)a_len,                     \
          (const int32_t*)keys_t, (const int32_t*)b_len,                     \
          (const int32_t*)block_w, (int32_t*)out, C, n, Rp, m, chunk, blk0,  \
          e_bits, off);                                                      \
    }                                                                        \
  } while (0)
  if (ns == 2)
    GF_PACKED(2);
  else
    GF_PACKED(1);
#undef GF_PACKED
  return (int)cudaGetLastError();
}

// K2 on the first `rows` rows of a prepared read operand (its rows that are
// not empty; the caller zeroes the rest).  Operands as for nw_fwd_packed;
// out is (ns, C, Rp), one plane per orientation.  A block has
// T threads (a multiple of 32; at most 1024 for K = 4, 512 for K = 8 and 16)
// of K columns each.  max_len is the longest read of the operand; when it
// exceeds T * K, scratch holds ns * C * Rp * 2 * n int32, else it may be
// null.  Launches on `stream` and returns cudaGetLastError().
extern "C" int nw_fwd_split(const void* a_keys, const void* a_len,
                            const void* keys_t, const void* b_len, void* out,
                            void* scratch, int C, int n, int Rp, int rows, int m,
                            int ns, int max_len, int K, int T, void* stream) {
  if (C <= 0 || C > 65535 || n <= 0 || Rp <= 0 || rows <= 0 || rows > Rp ||
      m <= 0 ||
      (ns != 1 && ns != 2) || (K != 4 && K != 8 && K != 16) || T < 32 ||
      T % 32 || T > (K == 4 ? 1024 : 512) ||
      (max_len > T * K && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const int NW = T / 32;
  int a_ring_size = 64;  // a power of two >= 64 * NW + 32 rows in flight
  while (a_ring_size < 64 * NW + 32) a_ring_size *= 2;
  const size_t smem = (size_t)(a_ring_size + 2 * NW * RING) * sizeof(int32_t);
  const dim3 grid(rows, C, ns);
  cudaStream_t st = (cudaStream_t)stream;
  int err;
#define GF_SPLIT(KK)                                                         \
  do {                                                                       \
    if ((err = prepare(nw_fwd_split_kernel<KK>, smem))) return err;          \
    nw_fwd_split_kernel<KK><<<grid, T, smem, st>>>(                          \
        (const int32_t*)a_keys, (const int32_t*)a_len,                       \
        (const int32_t*)keys_t, (const int32_t*)b_len, (int32_t*)out,        \
        (int32_t*)scratch, n, Rp, m, a_ring_size);                           \
  } while (0)
  if (K == 4)
    GF_SPLIT(4);
  else if (K == 8)
    GF_SPLIT(8);
  else
    GF_SPLIT(16);
#undef GF_SPLIT
  return (int)cudaGetLastError();
}
