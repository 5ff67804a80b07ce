// Smith-Waterman forward scoring of the align mode for Hopper (sm_90a),
// built by gfalign_torch/ops/cuda_build.py with nvcc into a shared library
// with a plain C interface and loaded with ctypes.
//
//   sa_banded_fwd (K3)     replaces gfalign_tpu/ops/seqalign_pallas.py
//                          _banded_kernel_factory and the strip assembly in
//                          front of it (_build_banded_arena);
//   sa_local_fwd  (K4, K5) replaces gfalign_tpu/ops/seqalign_pallas.py
//                          _kernel_factory: pairwise (read i against path i,
//                          K4) or cross product (every read against every
//                          path, K5).
//
// Scores: match +1, mismatch -2, gap -3, floor 0; a PAD (5) on either side
// scores -1000; code 4 (N) mismatches everything.
//
// Design.  One block owns one (read, path) pair and sweeps the DP row by
// row.  A row is spread over the block's threads, LPT neighbouring cells per
// thread in registers (band lanes for K3, path columns for K4/K5), so the
// previous row never leaves registers.  The horizontal chain
// H[x] = max(c[x], H[x-1] + GAP) is a max-plus prefix scan: each thread
// scans its own cells serially, the threads' last values are scanned with
// warp shuffles (log2(32) steps, the decay grows with the distance), warps
// hand their totals on through shared memory, and each thread then folds
// the carry into its cells.  The best cell is tracked per cell as a packed
// key (value << bits) - row with a plain max (largest value, then earliest
// row) and reduced once after the sweep, smaller lane or column winning
// ties.  Rows after a read's last non-PAD char are skipped: a PAD row
// blocks every cell, so what follows only decays and never raises a best.
//
// K3 reads nothing but indices: the block gathers its read row from the
// read pool and assembles its path strip (strip[t] = path char at
// t + delta - width/2, PAD outside the path) in shared memory from the
// oriented-segment arena and the path's step tables, so neither the
// gathered reads nor the strips pass through device memory.
//
// What bounds them: integer ALU instructions.  A pair's inputs are a few KB
// while every DP cell costs about a dozen int32 instructions (byte extract,
// compares, selects, maxes), so the bound is cells x ALU operations per cell
// over the ALU pipe's rate; chip_smoke.py (OPS_PER_CELL) counts them from
// the row loops below.  The row-to-row chain is serial inside a block (two
// block barriers per row when a row spans several warps); parallelism comes
// from the pairs, so a launch with a handful of pairs (K4 on band-edge
// survivors) leaves most of the card idle.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MATCH = 1;
constexpr int MISMATCH = -2;
constexpr int GAP = -3;
constexpr int PAD = 5;
constexpr int BLOCKV = -1000;      // PAD never extends an alignment
constexpr int NEG = -(1 << 28);    // below every reachable value
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;

__device__ __forceinline__ int subs(int r, int p) {
  return (r == PAD || p == PAD) ? BLOCKV
                                : ((r == p && r < 4) ? MATCH : MISMATCH);
}

// Carry of the max-plus scan INTO this thread: the chain's value at the last
// cell of the thread before it.  `tot` is the thread's own last value,
// `step` the decay over one thread's cells, `carry0` the chain's value just
// before thread 0.  With several warps the totals pass through wtot; the
// caller puts a block barrier between two calls.
__device__ __forceinline__ int scan_carry(int tot, int step, int carry0,
                                          int lane, int warp, int nwarps,
                                          int* wtot) {
  int s = tot;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(FULL, s, d);
    if (lane >= d) s = max(s, o - step * d);
  }
  const int prev = __shfl_up_sync(FULL, s, 1);
  int carry = lane > 0 ? prev : NEG;
  int g = carry0;  // the chain's value at the end of the warp before this one
  if (nwarps > 1) {
    if (lane == 31) wtot[warp] = s;
    __syncthreads();
    for (int w = 0; w < warp; ++w) g = max(g - step * 32, wtot[w]);
  }
  return max(carry, g - step * lane);
}

// Last non-PAD position + 1 of a code row, for the whole block.
__device__ __forceinline__ int live_rows(const int8_t* row, int len,
                                         int* slot) {
  if (threadIdx.x == 0) *slot = 0;
  __syncthreads();
  int last = 0;
  for (int i = threadIdx.x; i < len; i += blockDim.x)
    if (row[i] != PAD) last = i + 1;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    last = max(last, __shfl_down_sync(FULL, last, d));
  if ((threadIdx.x & 31) == 0 && last > 0) atomicMax(slot, last);
  __syncthreads();
  return *slot;
}

// Block-wide best (largest key, then smallest position); valid in thread 0.
template <typename KeyT>
__device__ __forceinline__ void reduce_best(KeyT& bk, int& bx, KeyT* red_k,
                                            int* red_x) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const KeyT ok = __shfl_down_sync(FULL, bk, d);
    const int ox = __shfl_down_sync(FULL, bx, d);
    if (ok > bk || (ok == bk && ox < bx)) {
      bk = ok;
      bx = ox;
    }
  }
  if (nwarps > 1) {
    __syncthreads();
    if (lane == 0) {
      red_k[warp] = bk;
      red_x[warp] = bx;
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int w = 1; w < nwarps; ++w)
        if (red_k[w] > bk || (red_k[w] == bk && red_x[w] < bx)) {
          bk = red_k[w];
          bx = red_x[w];
        }
  }
}

// K3: banded local alignment around diagonal delta, one block per pair.
// Band coordinates H[i][u], j = i + delta - width/2 + u: the diagonal keeps
// its lane, 'up' is lane u + 1 of the previous row (blocked at the last
// lane), the horizontal chain runs along the band, cells with j outside
// [1, plen] are 0.  Thread t owns lanes [t * LPT, (t + 1) * LPT); threads
// past the band are dead (width is a multiple of LPT).
template <int LPT, typename KeyT>
__global__ void __launch_bounds__(MAX_THREADS)
banded_fwd_kernel(const int8_t* __restrict__ arena, int arena_len,
                  const int32_t* __restrict__ cum_off,
                  const int32_t* __restrict__ base_ptr,
                  const int32_t* __restrict__ plen_pool, int n_paths, int S,
                  const int8_t* __restrict__ read_pool, int n_reads, int lr,
                  const int32_t* __restrict__ read_idx,
                  const int32_t* __restrict__ path_idx,
                  const int32_t* __restrict__ deltas,
                  int32_t* __restrict__ out, int N, int width, int key_bits) {
  extern __shared__ int32_t dyn[];
  __shared__ int wtot[MAX_WARPS], xch[MAX_WARPS], red_x[MAX_WARPS], rows_slot;
  __shared__ KeyT red_k[MAX_WARPS];
  const int n = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int ridx = min(max(read_idx[n], 0), n_reads - 1);
  const int pidx = min(max(path_idx[n], 0), n_paths - 1);
  const int8_t* read = read_pool + (size_t)ridx * lr;
  const int delta = deltas[n];
  const int plen = plen_pool[pidx];
  const int W2 = width / 2;
  int32_t* co_s = dyn;
  int32_t* bp_s = dyn + S;
  int8_t* strip = (int8_t*)(dyn + 2 * S);
  for (int s = tid; s < S; s += blockDim.x) {
    co_s[s] = cum_off[(size_t)pidx * S + s];
    bp_s[s] = base_ptr[(size_t)pidx * S + s];
  }
  const int n_rows = live_rows(read, lr, &rows_slot);  // has block barriers
  // the strip, assembled from the arena: path position x lives at
  // arena[base_ptr[k] + x] for the last step k with cum_off[k] <= x
  const int n_cols = n_rows + blockDim.x * LPT + 8;
  for (int t = tid; t < n_cols; t += blockDim.x) {
    const int x = t + delta - W2;
    int8_t ch = PAD;
    if (x >= 0 && x < plen) {
      int b = bp_s[0];
      for (int s = 1; s < S; ++s)
        if (co_s[s] <= x) b = bp_s[s];
      ch = arena[min(max(b + x, 0), arena_len - 1)];
    }
    strip[t] = ch;
  }
  __syncthreads();

  const uint32_t* strip32 = (const uint32_t*)strip;
  const int u0 = tid * LPT;
  const bool live = u0 < width;
  const bool last_live = u0 + LPT == width;
  const KeyT key_scale = (KeyT)1 << key_bits;
  int h[LPT];
  KeyT key[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    h[k] = live ? 0 : NEG;
    key[k] = 0;
  }
  if (nwarps > 1) {  // row 0 of the lanes that neighbouring warps exchange
    if (lane == 0) xch[warp] = h[0];
    __syncthreads();
  }
  int r_next = n_rows > 0 ? read[0] : PAD;
  for (int i = 1; i <= n_rows; ++i) {
    const int r = r_next;
    if (i < n_rows) r_next = read[i];
    // this row's window strip[i-1+u0 .. +LPT), four chars per word
    const int o = i - 1 + u0;
    const int wi = o >> 2, sh = (o & 3) * 8;
    uint32_t pk[LPT / 4];
    uint32_t lo = strip32[wi];
#pragma unroll
    for (int q = 0; q < LPT / 4; ++q) {
      const uint32_t hi = strip32[wi + q + 1];
      pk[q] = __funnelshift_r(lo, hi, sh);
      lo = hi;
    }
    // 'up' of the thread's last lane: the next thread's first lane
    int upn = __shfl_down_sync(FULL, h[0], 1);
    if (lane == 31) upn = (warp + 1 < nwarps) ? xch[warp + 1] : NEG;
    if (last_live) upn = BLOCKV;
    const int jb = i + delta - W2 + u0 - 1;  // j - 1 of the first lane
    const bool rpad = r == PAD;
    const bool rbase = r < 4;
    unsigned in_mask = 0;
    int run = NEG;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int p = (int)(int8_t)(pk[k >> 2] >> ((k & 3) * 8));
      const int s = (rpad || p == PAD) ? BLOCKV
                                       : ((rbase && r == p) ? MATCH : MISMATCH);
      const int up = k + 1 < LPT ? h[k + 1] : upn;
      int c = max(0, max(h[k] + s, up + GAP));
      const bool in = (unsigned)(jb + k) < (unsigned)plen;
      c = in ? c : 0;
      in_mask |= (unsigned)in << k;
      run = max(c, run + GAP);
      h[k] = run;
    }
    const int carry = scan_carry(run, -GAP * LPT, NEG, lane, warp, nwarps, wtot);
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      int hn = max(h[k], carry + GAP * (k + 1));
      hn = ((in_mask >> k) & 1u) ? hn : 0;
      if (live) key[k] = max(key[k], (KeyT)hn * key_scale - i);
      h[k] = live ? hn : NEG;
    }
    if (nwarps > 1) {
      if (lane == 0) xch[warp] = h[0];
      __syncthreads();
    }
  }
  KeyT bk = key[0];
  int bu = u0;
#pragma unroll
  for (int k = 1; k < LPT; ++k)
    if (key[k] > bk) {
      bk = key[k];
      bu = u0 + k;
    }
  reduce_best(bk, bu, red_k, red_x);
  if (tid == 0) {
    int best = 0, bi = 0, bj = 0, edge = 0;
    if (bk > 0) {
      best = (int)((bk + key_scale - 1) >> key_bits);
      bi = (int)((KeyT)best * key_scale - bk);
      bj = bi + delta - W2 + bu;
      edge = (bu <= 0 || bu >= width - 1) ? 1 : 0;
    }
    out[n] = best;
    out[(size_t)N + n] = bi;
    out[2 * (size_t)N + n] = bj;
    out[3 * (size_t)N + n] = edge;
  }
}

// K4 / K5: full local alignment of read blockIdx.x against path blockIdx.x
// (pairwise) or blockIdx.y (cross product).  Thread t owns columns
// (j0 + t * LPT, j0 + (t + 1) * LPT] of a strip of blockDim.x * LPT columns;
// a path wider than one strip is swept strip by strip, each strip handing
// its last column (one value per row) to the next through `scratch`
// (two planes of lr int32 per pair, used in turn).
template <int LPT, typename KeyT>
__global__ void __launch_bounds__(MAX_THREADS)
local_fwd_kernel(const int8_t* __restrict__ reads, int lr,
                 const int8_t* __restrict__ paths, int lp, int pairwise,
                 int32_t* __restrict__ out, int32_t* __restrict__ scratch,
                 int key_bits) {
  __shared__ int wtot[MAX_WARPS], xch[MAX_WARPS], red_x[MAX_WARPS], rows_slot;
  __shared__ KeyT red_k[MAX_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int rr = blockIdx.x;
  const int pp = pairwise ? rr : blockIdx.y;
  const size_t pair = pairwise ? (size_t)rr : (size_t)rr * gridDim.y + blockIdx.y;
  const size_t n_pairs = pairwise ? (size_t)gridDim.x
                                  : (size_t)gridDim.x * gridDim.y;
  const int8_t* read = reads + (size_t)rr * lr;
  const int8_t* path = paths + (size_t)pp * lp;
  const int n_rows = live_rows(read, lr, &rows_slot);
  const int strip_w = blockDim.x * LPT;
  const int n_strips = (lp + strip_w - 1) / strip_w;
  const KeyT key_scale = (KeyT)1 << key_bits;
  KeyT bk = 0;  // the thread's best over its columns of every strip
  int bj = 0;
  for (int s = 0; s < n_strips; ++s) {
    const int jt = s * strip_w + tid * LPT;  // the thread's columns: jt+1..
    int pc[LPT], h[LPT];
    KeyT key[LPT];
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      pc[k] = jt + k < lp ? path[jt + k] : PAD;  // past the path: inert PAD
      h[k] = 0;
      key[k] = 0;
    }
    const int32_t* sin = scratch + ((size_t)(s & 1) * n_pairs + pair) * lr;
    int32_t* sout = scratch + ((size_t)((s + 1) & 1) * n_pairs + pair) * lr;
    if (nwarps > 1) {  // row 0 of the columns that neighbouring warps exchange
      if (lane == 31) xch[warp] = 0;
      __syncthreads();
    }
    int left_prev = 0;  // H[i-1][j0], the strip's left boundary column
    int r_next = n_rows > 0 ? read[0] : PAD;
    int left_next = (s > 0 && n_rows > 0) ? sin[0] : 0;
    for (int i = 1; i <= n_rows; ++i) {
      const int r = r_next;
      const int left = left_next;  // H[i][j0]
      if (i < n_rows) {
        r_next = read[i];
        if (s > 0) left_next = sin[i];
      }
      // diagonal of the thread's first column: the last column before it
      int dg = __shfl_up_sync(FULL, h[LPT - 1], 1);
      if (lane == 0) dg = warp > 0 ? xch[warp - 1] : left_prev;
      int run = NEG;
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const int c = max(0, max(dg + subs(r, pc[k]), h[k] + GAP));
        dg = h[k];
        run = max(c, run + GAP);
        h[k] = run;
      }
      const int carry = scan_carry(run, -GAP * LPT, left, lane, warp, nwarps,
                                   wtot);
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const int hn = max(h[k], carry + GAP * (k + 1));
        key[k] = max(key[k], (KeyT)hn * key_scale - i);
        h[k] = hn;
      }
      left_prev = left;
      if (s + 1 < n_strips && tid == blockDim.x - 1) sout[i - 1] = h[LPT - 1];
      if (nwarps > 1) {
        if (lane == 31) xch[warp] = h[LPT - 1];
        __syncthreads();
      }
    }
#pragma unroll
    for (int k = 0; k < LPT; ++k)
      if (key[k] > bk) {
        bk = key[k];
        bj = jt + k + 1;
      }
    __syncthreads();  // the next strip reads what this one wrote
  }
  reduce_best(bk, bj, red_k, red_x);
  if (tid == 0) {
    int best = 0, bi = 0;
    if (bk > 0) {
      best = (int)((bk + key_scale - 1) >> key_bits);
      bi = (int)((KeyT)best * key_scale - bk);
    } else {
      bj = 0;
    }
    out[pair] = best;
    out[n_pairs + pair] = bi;
    out[2 * n_pairs + pair] = bj;
  }
}

int bit_length(long long x) {
  int k = 0;
  while (x >> k) ++k;
  return k;
}

int round_up(int x, int q) { return (x + q - 1) / q * q; }

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024) {
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// Lanes per thread of the banded kernel for this width, or 0 when the width
// is not served (the wrapper raises).
extern "C" int sa_banded_lanes(int width) {
  if (width >= 512 && width % 16 == 0 && width / 16 <= MAX_THREADS) return 16;
  if (width >= 4 && width % 4 == 0 && width / 4 <= MAX_THREADS) return 4;
  return 0;
}

// K3.  arena (arena_len,) int8; cum_off, base_ptr (n_paths, S) int32; plen
// (n_paths,) int32; read_pool (n_reads, lr) int8; read_idx, path_idx, deltas
// (N,) int32; out (4, N) int32: best, end row, end column, band-edge flag.
// All contiguous on one device.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int sa_banded_fwd(const void* arena, int arena_len,
                             const void* cum_off, const void* base_ptr,
                             const void* plen, int n_paths, int S,
                             const void* read_pool, int n_reads, int lr,
                             const void* read_idx, const void* path_idx,
                             const void* deltas, void* out, int N, int width,
                             void* stream) {
  const int lpt = sa_banded_lanes(width);
  if (N <= 0 || lpt == 0 || arena_len <= 0 || n_paths <= 0 || S <= 0 ||
      n_reads <= 0 || lr <= 0)
    return (int)cudaErrorInvalidValue;
  const int threads = round_up(width / lpt, 32);
  const int key_bits = bit_length((long long)lr + 2);
  const bool wide = ((long long)(lr + 1) << key_bits) >= (1LL << 31);
  const size_t smem = (size_t)2 * S * sizeof(int32_t) +
                      round_up(lr + threads * lpt + 8, 4);
  cudaStream_t st = (cudaStream_t)stream;
  int err = 0;
#define GF_BANDED(LPT, KEY)                                                  \
  do {                                                                       \
    if ((err = prepare(banded_fwd_kernel<LPT, KEY>, smem))) return err;      \
    banded_fwd_kernel<LPT, KEY><<<N, threads, smem, st>>>(                   \
        (const int8_t*)arena, arena_len, (const int32_t*)cum_off,            \
        (const int32_t*)base_ptr, (const int32_t*)plen, n_paths, S,          \
        (const int8_t*)read_pool, n_reads, lr, (const int32_t*)read_idx,     \
        (const int32_t*)path_idx, (const int32_t*)deltas, (int32_t*)out, N,  \
        width, key_bits);                                                    \
  } while (0)
  if (lpt == 16) {
    if (wide) GF_BANDED(16, long long); else GF_BANDED(16, int);
  } else {
    if (wide) GF_BANDED(4, long long); else GF_BANDED(4, int);
  }
#undef GF_BANDED
  return (int)cudaGetLastError();
}

// Columns per strip of the local kernel for paths of lp columns (the
// wrapper sizes the scratch planes from it).
extern "C" int sa_local_strip(int lp) {
  const int lpt = lp <= 4 * MAX_THREADS ? 4 : 16;
  const int threads = round_up((lp + lpt - 1) / lpt, 32);
  return (threads < MAX_THREADS ? threads : MAX_THREADS) * lpt;
}

// K4 (pairwise != 0: reads (R, lr) against paths (R, lp), out (3, R)) and
// K5 (pairwise == 0: reads (R, lr) against paths (P, lp), out (3, R, P)):
// best, end row, end column, int32.  scratch holds 2 * pairs * lr int32 and
// may be null when lp <= sa_local_strip(lp).
extern "C" int sa_local_fwd(const void* reads, int R, int lr,
                            const void* paths, int P, int lp, int pairwise,
                            void* out, void* scratch, void* stream) {
  if (R <= 0 || P <= 0 || lr <= 0 || lp <= 0 || (!pairwise && P > 65535))
    return (int)cudaErrorInvalidValue;
  const int strip_w = sa_local_strip(lp);
  if (lp > strip_w && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int lpt = lp <= 4 * MAX_THREADS ? 4 : 16;
  const int threads = strip_w / lpt;
  const int key_bits = bit_length((long long)lr + 2);
  const long long vmax = lr < lp ? lr : lp;
  const bool wide = ((vmax + 1) << key_bits) >= (1LL << 31);
  const dim3 grid(R, pairwise ? 1 : P);
  cudaStream_t st = (cudaStream_t)stream;
#define GF_LOCAL(LPT, KEY)                                                   \
  local_fwd_kernel<LPT, KEY><<<grid, threads, 0, st>>>(                      \
      (const int8_t*)reads, lr, (const int8_t*)paths, lp, pairwise,          \
      (int32_t*)out, (int32_t*)scratch, key_bits)
  if (lpt == 16) {
    if (wide) GF_LOCAL(16, long long); else GF_LOCAL(16, int);
  } else {
    if (wide) GF_LOCAL(4, long long); else GF_LOCAL(4, int);
  }
#undef GF_LOCAL
  return (int)cudaGetLastError();
}
