// Smith-Waterman forward scoring of the align mode for Hopper (sm_90a),
// built by gfalign_torch/ops/cuda_build.py with nvcc into a shared library
// with a plain C interface and loaded with ctypes.
//
//   sa_banded_fwd (K3)     replaces gfalign_tpu/ops/seqalign_pallas.py
//                          _banded_kernel_factory and the strip assembly in
//                          front of it (_build_banded_arena);
//   sa_pairs_fwd  (K4)     replaces gfalign_tpu/ops/seqalign_pallas.py
//                          _kernel_factory as the pairwise scorer (read i
//                          against path i);
//   sa_local_fwd  (K5)     replaces the same _kernel_factory as the cross
//                          product (every read against every path).
//
// Scores: match +1, mismatch -2, gap -3, floor 0; a PAD (5) on either side
// scores -1000; code 4 (N) mismatches everything.
//
// Common ground.  The DP runs row by row, each thread holding a few
// neighbouring cells of a row in registers (band lanes for K3, path columns
// for K4/K5), so the previous row never leaves registers.  The best cell is
// tracked per cell as a packed key (value << bits) - row with a plain max
// (largest value, then earliest row) and reduced once after the sweep,
// smaller lane or column winning ties.  Rows after a read's last non-PAD
// char are skipped: a PAD row blocks every cell, so what follows only
// decays and never raises a best.
//
// What bounds them: integer ALU instructions.  A pair's inputs are a few KB
// while every DP cell costs about a dozen int32 instructions (byte extract,
// compares, selects, maxes), so the bound is cells x ALU operations per cell
// over the ALU pipe's rate; chip_smoke.py (OPS_PER_CELL) counts them from
// the row loops below.  The row-to-row chain is serial within a pair, so
// each kernel's design is about keeping enough independent chains in
// flight and few instructions beside the cells; each kernel's note below
// says how.

#include <cstdint>
#include <type_traits>
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

// K3 rows: per pair, the read's last non-PAD position + 1 (one warp a
// pair).  The launcher sorts the pairs by it, longest first, so that the
// long reads start first and the pairs sharing a warp have alike rows.
__global__ void banded_rows_kernel(const int8_t* __restrict__ read_pool,
                                   int n_reads, int lr,
                                   const int32_t* __restrict__ read_idx,
                                   int32_t* __restrict__ rows, int N) {
  const int n = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (n >= N) return;  // whole warps
  const int ridx = min(max(read_idx[n], 0), n_reads - 1);
  const int8_t* read = read_pool + (size_t)ridx * lr;
  int last = 0;
  if ((((uintptr_t)read_pool | (uintptr_t)lr) & 3) == 0) {  // rows on words
    const uint32_t* words = (const uint32_t*)read;
    for (int q = lane; q < lr / 4; q += 32) {
      const uint32_t v = words[q];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if ((int)((v >> (8 * b)) & 0xffu) != PAD) last = 4 * q + b + 1;
    }
  } else {
    for (int i = lane; i < lr; i += 32)
      if (read[i] != PAD) last = i + 1;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    last = max(last, __shfl_down_sync(FULL, last, d));
  if (lane == 0) rows[n] = last;
}

// K3, one block per pair (widths over 512, or not multiples of 16).  Band
// coordinates H[i][u], j = i + delta - width/2 + u: the diagonal keeps its
// lane, 'up' is lane u + 1 of the previous row (blocked at the last lane),
// the horizontal chain runs along the band, cells with j outside [1, plen]
// are 0.  Thread t owns lanes [t * LPT, (t + 1) * LPT); threads past the
// band are dead (width is a multiple of LPT).  Block b scores pair
// order[b]; the strip (the read's rows plus the band) is assembled whole in
// shared memory, and the horizontal chain is a block-wide max-plus scan
// (two block barriers a row).
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
                  const int32_t* __restrict__ order,
                  const int32_t* __restrict__ rows,
                  int32_t* __restrict__ out, int N, int width, int key_bits) {
  extern __shared__ int32_t dyn[];
  __shared__ int wtot[MAX_WARPS], xch[MAX_WARPS], red_x[MAX_WARPS];
  __shared__ KeyT red_k[MAX_WARPS];
  const int n = order[blockIdx.x];
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
  const int n_rows = rows[n];
  __syncthreads();  // the step tables
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

// K3 (sa_banded_fwd), bands of at most 32 threads: widths up to 512 that
// are multiples of 16 (L = 16 lanes a thread).  Replaces
// gfalign_tpu/ops/seqalign_pallas.py _banded_kernel_factory (pallas_call at
// :383) with the strip assembly in front of it.
//
// Bound: integer ALU operations (OPS_PER_CELL["banded"] in chip_smoke.py).
// The block-per-pair kernel above spent a long max-plus scan (5 shuffle
// stages over 32 threads) and a shuffle per row on 4 cells a thread at
// width 128, and kept its whole strip (lr + width bytes) in shared memory,
// which capped the resident pairs below one wave.  This design:
//   * a pair is a GROUP of G threads (G a power of two, width <= G * L) in
//     one warp, 32 / G pairs a warp: the scan is log2(G) segmented
//     shuffles (3 at width 128) over 16 cells a thread, and a warp runs
//     32 / G independent chains in the same instructions;
//   * the strip lives in a ring of RB bytes per pair (a power of two above
//     width + 36), refilled 32 positions every 32 rows by the group's own
//     threads straight from the segment arena (each thread walks the step
//     table with a cursor, as positions only grow), so shared memory no
//     longer caps residency;
//   * pairs come sorted by live rows, longest first (`order`): the long
//     reads start first, and the groups of a warp, which all loop to the
//     warp's longest, waste few rows.
// Group g of block b scores pair order[b * (blockDim.x / G) + g].
constexpr int GROUP_THREADS = 128;
// Keys (value << 16) - row fit an int32 while rows stay below 2^15; longer
// reads take int64 keys (value << 32) - row.  A constant shift lets the key
// be one multiply-add.
constexpr int KEY16_MAX_LR = 32766;
constexpr int RING_CHUNK = 32;  // rows between two ring refills

template <int L, int G, typename KeyT>
__global__ void __launch_bounds__(GROUP_THREADS)
banded_group_kernel(const int8_t* __restrict__ arena, int arena_len,
                    const int32_t* __restrict__ cum_off,
                    const int32_t* __restrict__ base_ptr,
                    const int32_t* __restrict__ plen_pool, int n_paths, int S,
                    const int8_t* __restrict__ read_pool, int n_reads, int lr,
                    const int32_t* __restrict__ read_idx,
                    const int32_t* __restrict__ path_idx,
                    const int32_t* __restrict__ deltas,
                    const int32_t* __restrict__ order,
                    const int32_t* __restrict__ rows,
                    int32_t* __restrict__ out, int N, int width,
                    int ring_bytes) {
  extern __shared__ int32_t dyn[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int t = lane % G;      // thread in the group
  const int grp = tid / G;     // group in the block
  const int slot = blockIdx.x * (blockDim.x / G) + grp;
  const bool valid = slot < N;
  const int n = valid ? order[slot] : 0;
  const int n_rows = valid ? rows[n] : 0;
  int wrows = n_rows;  // the warp's longest: every group loops to it
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    wrows = max(wrows, __shfl_xor_sync(FULL, wrows, d));
  const int ridx = min(max(read_idx[n], 0), n_reads - 1);
  const int pidx = min(max(path_idx[n], 0), n_paths - 1);
  const int8_t* read = read_pool + (size_t)ridx * lr;
  const int32_t* co = cum_off + (size_t)pidx * S;
  const int32_t* bp = base_ptr + (size_t)pidx * S;
  const int delta = deltas[n];
  const int plen = plen_pool[pidx];
  const int W2 = width / 2;
  uint32_t* ring32 = (uint32_t*)dyn + (size_t)grp * (ring_bytes / 4);
  int8_t* ring = (int8_t*)ring32;
  const int bmask = ring_bytes - 1, wmask = ring_bytes / 4 - 1;
  // strip position p (path position p + delta - W2) lives at ring[p & bmask]
  int cursor = 0;    // the step of this thread's last fetched position
  int pad_rows = 0;  // rows up to this one may see a PAD of the path itself
  auto fill = [&](int p0, int count) {
    for (int q = t; q < count; q += G) {
      const int p = p0 + q;
      const int x = p + delta - W2;
      int8_t ch = PAD;
      if (x >= 0 && x < plen) {  // the last step k with cum_off[k] <= x
        while (cursor + 1 < S && co[cursor + 1] <= x) ++cursor;
        ch = arena[min(max(bp[cursor] + x, 0), arena_len - 1)];
        if (ch == PAD) pad_rows = p + 1;  // row i reads positions >= i - 1
      }
      ring[p & bmask] = ch;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)  // warp-uniform, like the row loop
      pad_rows = max(pad_rows, __shfl_xor_sync(FULL, pad_rows, d));
  };
  // a row i reads strip positions [i - 1, i + width + 3): before the chunk
  // of rows (c0, c0 + 32] the ring holds [c0 + filled - ring_bytes,
  // c0 + filled)
  const int filled = (width + 36 + 31) / 32 * 32;
  fill(0, filled);
  __syncwarp();

  const int u0 = t * L;
  const bool last_live = u0 + L == width;
  constexpr int KEY_BITS = sizeof(KeyT) == 4 ? 16 : 32;
  constexpr KeyT KEY_SCALE = (KeyT)1 << KEY_BITS;
  int h[L];
  KeyT key[L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    h[k] = 0;
    key[k] = 0;
  }
  // Cells off the path (j outside [1, plen]), which the plain version sets
  // to 0, are not masked here: their strip chars are PAD, so left of the
  // path they come out 0 by themselves, and right of it every value is
  // below one of a cell of the path at the same or an earlier row (each
  // move into them loses), feeds no cell of the path (no move goes left),
  // and so never makes a key win.  The same holds for the rows past the
  // group's own n_rows (up to the warp's longest), which are PAD rows, and
  // for the lanes of dead threads past the band, whose keys are dropped.
  int r_next = wrows > 0 ? read[0] : PAD;
  auto row = [&](auto pads, int i) {
    const int r = r_next;
    if (i < wrows) r_next = read[i];
    // this row's window strip[i-1+u0 .. +L), four chars per word
    const int o = i - 1 + u0;
    const int wi = o >> 2, sh = (o & 3) * 8;
    uint32_t pk[L / 4];
    uint32_t lo = ring32[wi & wmask];
#pragma unroll
    for (int q = 0; q < L / 4; ++q) {
      const uint32_t hi = ring32[(wi + q + 1) & wmask];
      pk[q] = __funnelshift_r(lo, hi, sh);
      lo = hi;
    }
    // 'up' of the thread's last lane: the next thread's first lane
    int upn = __shfl_down_sync(FULL, h[0], 1, G);
    if (last_live) upn = BLOCKV;
    const int s_match = r == PAD ? BLOCKV : MATCH;
    const int s_mis = r == PAD ? BLOCKV : MISMATCH;
    const int rk = r < 4 ? r : 0xff;  // N and PAD match nothing
    int run = NEG;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int p = (int)((pk[k >> 2] >> ((k & 3) * 8)) & 0xffu);
      int s = p == rk ? s_match : s_mis;
      if (decltype(pads)::value && p == PAD) s = BLOCKV;
      const int up = k + 1 < L ? h[k + 1] : upn;
      const int c = __viaddmax_s32_relu(h[k], s, up + GAP);
      run = __viaddmax_s32(run, GAP, c);
      h[k] = run;
    }
    // carry into this thread: the group's max-plus scan of the threads'
    // last values, the decay growing with the distance
    int sc = run;
#pragma unroll
    for (int d = 1; d < G; d <<= 1) {
      const int ov = __shfl_up_sync(FULL, sc, d, G);
      if (t >= d) sc = max(sc, ov + GAP * L * d);
    }
    int carry = __shfl_up_sync(FULL, sc, 1, G);
    carry = t > 0 ? carry : NEG;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      h[k] = __viaddmax_s32(carry, GAP * (k + 1), h[k]);
      key[k] = max(key[k], (KeyT)h[k] * KEY_SCALE - i);
    }
  };
  for (int c0 = 0; c0 < wrows; c0 += RING_CHUNK) {
    if (c0 > 0) {
      __syncwarp();  // the previous chunk's reads are done
      fill(filled + c0 - RING_CHUNK, RING_CHUNK);
      __syncwarp();
    }
    const int c1 = min(c0 + RING_CHUNK, wrows);
    // A PAD off the path may score as a mismatch (its cells' values do not
    // matter, see above); one of the path itself must block, so the rows
    // that can see one (up to pad_rows, warp-uniform) take PADS.
    const int cp = min(c1, max(c0, pad_rows));
    for (int i = c0 + 1; i <= cp; ++i) row(std::true_type{}, i);
    for (int i = cp + 1; i <= c1; ++i) row(std::false_type{}, i);
  }
  KeyT bk = key[0];
  int bu = u0;
#pragma unroll
  for (int k = 1; k < L; ++k)
    if (key[k] > bk) {
      bk = key[k];
      bu = u0 + k;
    }
  if (u0 >= width) bk = 0;  // a dead thread
#pragma unroll
  for (int d = G / 2; d > 0; d >>= 1) {
    const KeyT ok = __shfl_down_sync(FULL, bk, d, G);
    const int ox = __shfl_down_sync(FULL, bu, d, G);
    if (ok > bk || (ok == bk && ox < bu)) {
      bk = ok;
      bu = ox;
    }
  }
  if (t == 0 && valid) {
    int best = 0, bi = 0, bj = 0, edge = 0;
    if (bk > 0) {
      best = (int)((bk + KEY_SCALE - 1) >> KEY_BITS);
      bi = (int)((KeyT)best * KEY_SCALE - bk);
      bj = bi + delta - W2 + bu;
      edge = (bu <= 0 || bu >= width - 1) ? 1 : 0;
    }
    out[n] = best;
    out[(size_t)N + n] = bi;
    out[2 * (size_t)N + n] = bj;
    out[3 * (size_t)N + n] = edge;
  }
}

// K5: full local alignment of read blockIdx.x against path blockIdx.y
// (cross product).  Thread t owns columns
// (j0 + t * LPT, j0 + (t + 1) * LPT] of a strip of blockDim.x * LPT columns;
// a path wider than one strip is swept strip by strip, each strip handing
// its last column (one value per row) to the next through `scratch`
// (two planes of lr int32 per pair, used in turn).
template <int LPT, typename KeyT>
__global__ void __launch_bounds__(MAX_THREADS)
local_fwd_kernel(const int8_t* __restrict__ reads, int lr,
                 const int8_t* __restrict__ paths, int lp,
                 int32_t* __restrict__ out, int32_t* __restrict__ scratch,
                 int key_bits) {
  __shared__ int wtot[MAX_WARPS], xch[MAX_WARPS], red_x[MAX_WARPS], rows_slot;
  __shared__ KeyT red_k[MAX_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int rr = blockIdx.x;
  const int pp = blockIdx.y;
  const size_t pair = (size_t)rr * gridDim.y + blockIdx.y;
  const size_t n_pairs = (size_t)gridDim.x * gridDim.y;
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

// K4 (sa_pairs_fwd): full local alignment of read p against path p.
// Replaces gfalign_tpu/ops/seqalign_pallas.py _kernel_factory as the
// pairwise scorer (pallas_call at :445).
//
// Bound: integer ALU operations (OPS_PER_CELL["pairs"] in chip_smoke.py).
// The local kernel above gives a pair one block, so the band-edge run's
// dozen pairs worked on a dozen of 132 SMs, and each row paid a block-wide
// scan and two block barriers.  This design:
//   * a pair's columns are split over PARTS blocks of T threads, K columns
//     a thread (ops/seqalign_cuda.pairs_layout picks them: a few pairs are
//     split so that they still fill the card, many take a block each);
//   * inside a block the threads run K2's skewed wavefront
//     (csrc/nw_path.cu): lane l of warp w works on row s - l at step s with
//     its left column from lane l - 1 by one shuffle, so the horizontal
//     chain is serial and exact and needs no scan; warp w runs two batches
//     of 32 rows behind warp w - 1, its left column through a ring in
//     shared memory, one block barrier per 32 rows;
//   * between the blocks of a pair the last column goes through global
//     memory (`hand`, lr words a block) with a progress word a block:
//     block p publishes the rows it has finished after each batch, block
//     p + 1 waits for the rows of its next batch.  Blocks take their place
//     by ticket (an atomic counter), so a block only ever waits for one
//     that is already running, whatever order the card starts them in;
//   * each block leaves its best (key, column); the last block of a pair
//     to finish reduces them, smaller column winning ties.
// Workspace (int32 words, see sa_pairs_workspace): ticket, done[R],
// progress[R * PARTS] (zeroed by the launcher), keys[R * PARTS] (int64),
// columns[R * PARTS], hand[R * PARTS * lr].
constexpr int HRING = 128;  // rows of the between-warp ring (power of two)

#ifndef GF_HOST_SHIM
// A block's progress word: written with release semantics after the column
// it covers, read with acquire semantics (cheaper than __threadfence, a
// sequentially consistent fence, on each side).
__device__ __forceinline__ void store_release(int32_t* p, int32_t v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}
__device__ __forceinline__ int32_t load_acquire(const int32_t* p) {
  int32_t v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}
#endif

template <int K, typename KeyT>
__global__ void __launch_bounds__(MAX_THREADS)
pairs_fwd_kernel(const int8_t* __restrict__ reads, int lr,
                 const int8_t* __restrict__ paths, int lp, int R, int parts,
                 int32_t* __restrict__ out, int32_t* work, int a_ring_size) {
  extern __shared__ int32_t sm[];
  __shared__ int ticket_s, rows_slot, red_x[MAX_WARPS];
  __shared__ KeyT red_k[MAX_WARPS];
  const int t = threadIdx.x, w = t >> 5, l = t & 31;
  const int T = blockDim.x, NW = T >> 5;
  const int n_blocks = R * parts;
  int32_t* done = work + 1;
  int32_t* progress = work + 1 + R;
  const size_t zeroed = (size_t)(1 + R + n_blocks + 1) & ~(size_t)1;
  long long* part_key = (long long*)(work + zeroed);
  int32_t* part_col = work + zeroed + 2 * (size_t)n_blocks;
  int32_t* hand = part_col + n_blocks;
  if (t == 0) ticket_s = atomicAdd(work, 1);
  __syncthreads();
  const int ticket = ticket_s;
  const int pair = ticket / parts, part = ticket % parts;
  const int8_t* read = reads + (size_t)pair * lr;
  const int8_t* path = paths + (size_t)pair * lp;
  const int n_rows = live_rows(read, lr, &rows_slot);
  int32_t* a_ring = sm;
  int32_t* ring_h = sm + a_ring_size;
  const int amask = a_ring_size - 1;
  const int32_t* hand_in = hand + (size_t)(ticket - 1) * lr;  // part > 0
  int32_t* hand_out = hand + (size_t)ticket * lr;
  const int jbase = (part * T + t) * K;  // the thread's columns: jbase + 1..
  constexpr int KEY_BITS = sizeof(KeyT) == 4 ? 16 : 32;
  constexpr KeyT KEY_SCALE = (KeyT)1 << KEY_BITS;
  int pc[K], h[K];
  KeyT key[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    pc[k] = jbase + k < lp ? path[jbase + k] : PAD;  // past the path: inert
    h[k] = 0;
    key[k] = 0;
  }
  bool pad_col = false;  // a PAD column among the warp's (past the path)
#pragma unroll
  for (int k = 0; k < K; ++k) pad_col |= pc[k] == PAD;
  pad_col = __any_sync(FULL, pad_col);
  const bool col0 = w == 0 && part == 0;  // lane 0 borders column 0
  int dg0 = 0;     // H[i-1][jbase]: the left column one row up
  int last_h = 0;  // H[i][jbase + K] of this lane's latest row
  // One wavefront step of this lane: row i of its K columns.  GUARDED steps
  // skip the rows outside 1..n_rows (the wavefront's ramps).  Lane 0 takes
  // its left column from the ring: warp w - 1's, or for warp 0 the left
  // block's, copied there at the batch's start.
  auto step = [&](auto guarded, auto pads, int i) {
    int in = __shfl_up_sync(FULL, last_h, 1);
    if (decltype(guarded)::value && (i < 1 || i > n_rows)) return;
    const int ring_in = ring_h[w * HRING + (i & (HRING - 1))];
    if (l == 0) in = col0 ? 0 : ring_in;
    const int r = a_ring[(i - 1) & amask];
    const int s_match = r == PAD ? BLOCKV : MATCH;
    const int s_mis = r == PAD ? BLOCKV : MISMATCH;
    const int rk = r < 4 ? r : -1;  // N and PAD match nothing
    int dg = dg0, left = in;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      int s = pc[k] == rk ? s_match : s_mis;
      if (decltype(pads)::value && pc[k] == PAD) s = BLOCKV;
      const int c = __viaddmax_s32_relu(dg, s, h[k] + GAP);
      dg = h[k];
      left = __viaddmax_s32(left, GAP, c);
      h[k] = left;
      key[k] = max(key[k], (KeyT)left * KEY_SCALE - i);
    }
    dg0 = in;
    last_h = left;
    if (l == 31) {
      if (w + 1 < NW)
        ring_h[(w + 1) * HRING + (i & (HRING - 1))] = last_h;
      else if (part + 1 < parts)
        hand_out[i - 1] = last_h;
    }
  };
  const int G = n_rows > 0 ? 2 * (NW - 1) + (n_rows + 30) / 32 + 1 : 0;
  auto batch = [&](auto pads, int g) {
    const int sbase = 32 * (g - 2 * w);  // this warp's step at u = 0
    if (sbase < 0 || sbase - 30 > n_rows) return;
    const int i0 = sbase - l + 1;  // this lane's row at u = 0
    if (sbase - 30 >= 1 && sbase + 32 <= n_rows) {  // every row is live
      for (int u = 0; u < 32; ++u) step(std::false_type{}, pads, i0 + u);
    } else {
      for (int u = 0; u < 32; ++u) step(std::true_type{}, pads, i0 + u);
    }
  };
  // warp 0 stages the read chars one batch ahead of their use
  if (t < 32) a_ring[t] = t < n_rows ? read[t] : PAD;
  for (int g = 0; g < G; ++g) {
    if (t < 32) {
      const int rr = 32 * g + t;
      if (part > 0 && 32 * g - 30 <= n_rows) {
        // the left block's last column for warp 0's rows of this batch
        const int need = min(n_rows, 32 * g + 32);
        if (t == 0)
          while (load_acquire(progress + ticket - 1) < need) {
          }
        __syncwarp();
        if (rr < n_rows)
          ring_h[(rr + 1) & (HRING - 1)] = __ldcg(hand_in + rr);
      }
      a_ring[(rr + 32) & amask] = rr + 32 < n_rows ? read[rr + 32] : PAD;
    }
    __syncthreads();
    if (pad_col)
      batch(std::true_type{}, g);
    else
      batch(std::false_type{}, g);
    if (part + 1 < parts && t == T - 1) {  // rows whose last column is out
      const int rows_done = min(n_rows, 32 * (g - 2 * (NW - 1)) + 1);
      if (rows_done > 0) store_release(progress + ticket, rows_done);
    }
  }
  KeyT bk = 0;
  int bj = 0;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (key[k] > bk) {
      bk = key[k];
      bj = jbase + k + 1;
    }
  reduce_best(bk, bj, red_k, red_x);
  if (t == 0) {
    part_key[ticket] = (long long)bk;
    part_col[ticket] = bj;
    __threadfence();
    if (atomicAdd(done + pair, 1) == parts - 1) {  // the pair's last block
      __threadfence();
      long long best_k = 0;
      int best_j = 0;
      for (int p = 0; p < parts; ++p) {  // left to right: ties keep the left
        const long long kk = __ldcg(part_key + (size_t)pair * parts + p);
        const int jj = __ldcg(part_col + (size_t)pair * parts + p);
        if (kk > best_k) {
          best_k = kk;
          best_j = jj;
        }
      }
      int best = 0, bi = 0;
      if (best_k > 0) {
        best = (int)((best_k + KEY_SCALE - 1) >> KEY_BITS);
        bi = (int)((long long)best * KEY_SCALE - best_k);
      } else {
        best_j = 0;
      }
      out[pair] = best;
      out[R + pair] = bi;
      out[2 * R + pair] = best_j;
    }
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

// K3, first pass: rows (N,) int32, each pair's live read rows.
extern "C" int sa_banded_rows(const void* read_pool, int n_reads, int lr,
                              const void* read_idx, void* rows, int N,
                              void* stream) {
  if (N <= 0 || n_reads <= 0 || lr <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int blocks = (int)(((long long)N * 32 + threads - 1) / threads);
  banded_rows_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)read_pool, n_reads, lr, (const int32_t*)read_idx,
      (int32_t*)rows, N);
  return (int)cudaGetLastError();
}

// Ring bytes a pair of the group kernel keeps for its strip.
extern "C" int sa_banded_ring(int width) {
  int rb = 64;
  while (rb < (width + 36 + 31) / 32 * 32 + 4) rb *= 2;
  return rb;
}

// K3.  arena (arena_len,) int8; cum_off, base_ptr (n_paths, S) int32
// (cum_off rows non-decreasing, as the strip assembly takes them); plen
// (n_paths,) int32; read_pool (n_reads, lr) int8; read_idx, path_idx, deltas
// (N,) int32; order (N,) int32, the pairs longest first, and rows (N,) int32
// from sa_banded_rows; out (4, N) int32: best, end row, end column,
// band-edge flag.  All contiguous on one device.  group = 0 takes the
// block-per-pair kernel with `lanes` 4 or 16 a thread; group in
// {1, 2, 4, 8, 16, 32} the group kernel with 16 lanes and
// width <= group * 16 (ops/seqalign_cuda.banded_layout picks them).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int sa_banded_fwd(const void* arena, int arena_len,
                             const void* cum_off, const void* base_ptr,
                             const void* plen, int n_paths, int S,
                             const void* read_pool, int n_reads, int lr,
                             const void* read_idx, const void* path_idx,
                             const void* deltas, const void* order,
                             const void* rows, void* out, int N, int width,
                             int lanes, int group, void* stream) {
  if (N <= 0 || arena_len <= 0 || n_paths <= 0 || S <= 0 || n_reads <= 0 ||
      lr <= 0 || (lanes != 4 && lanes != 16) || width < lanes ||
      width % lanes)
    return (int)cudaErrorInvalidValue;
  const int key_bits = bit_length((long long)lr + 2);
  const bool wide = ((long long)(lr + 1) << key_bits) >= (1LL << 31);
  cudaStream_t st = (cudaStream_t)stream;
  int err = 0;
  if (group == 0) {
    if (width / lanes > MAX_THREADS) return (int)cudaErrorInvalidValue;
    const int threads = round_up(width / lanes, 32);
    const size_t smem = (size_t)2 * S * sizeof(int32_t) +
                        round_up(lr + threads * lanes + 8, 4);
#define GF_BANDED(LPT, KEY)                                                  \
  do {                                                                       \
    if ((err = prepare(banded_fwd_kernel<LPT, KEY>, smem))) return err;      \
    banded_fwd_kernel<LPT, KEY><<<N, threads, smem, st>>>(                   \
        (const int8_t*)arena, arena_len, (const int32_t*)cum_off,            \
        (const int32_t*)base_ptr, (const int32_t*)plen, n_paths, S,          \
        (const int8_t*)read_pool, n_reads, lr, (const int32_t*)read_idx,     \
        (const int32_t*)path_idx, (const int32_t*)deltas,                    \
        (const int32_t*)order, (const int32_t*)rows, (int32_t*)out, N,       \
        width, key_bits);                                                    \
  } while (0)
    if (lanes == 16) {
      if (wide) GF_BANDED(16, long long); else GF_BANDED(16, int);
    } else {
      if (wide) GF_BANDED(4, long long); else GF_BANDED(4, int);
    }
#undef GF_BANDED
    return (int)cudaGetLastError();
  }
  if (lanes != 16 || width > group * lanes || group > 32 ||
      (group & (group - 1)))
    return (int)cudaErrorInvalidValue;
  const int ring = sa_banded_ring(width);
  const int per_block = GROUP_THREADS / group;
  const size_t smem = (size_t)per_block * ring;
  const int blocks = (N + per_block - 1) / per_block;
#define GF_GROUP(L, G, KEY)                                                  \
  do {                                                                       \
    if ((err = prepare(banded_group_kernel<L, G, KEY>, smem))) return err;   \
    banded_group_kernel<L, G, KEY><<<blocks, GROUP_THREADS, smem, st>>>(     \
        (const int8_t*)arena, arena_len, (const int32_t*)cum_off,            \
        (const int32_t*)base_ptr, (const int32_t*)plen, n_paths, S,          \
        (const int8_t*)read_pool, n_reads, lr, (const int32_t*)read_idx,     \
        (const int32_t*)path_idx, (const int32_t*)deltas,                    \
        (const int32_t*)order, (const int32_t*)rows, (int32_t*)out, N,       \
        width, ring);                                                        \
  } while (0)
#define GF_GROUP_KEY(L, G)                                                   \
  case G:                                                                    \
    if (lr > KEY16_MAX_LR) GF_GROUP(L, G, long long); else GF_GROUP(L, G, int); \
    break
  switch (group) {
    GF_GROUP_KEY(16, 1);
    GF_GROUP_KEY(16, 2);
    GF_GROUP_KEY(16, 4);
    GF_GROUP_KEY(16, 8);
    GF_GROUP_KEY(16, 16);
    GF_GROUP_KEY(16, 32);
  }
#undef GF_GROUP_KEY
#undef GF_GROUP
  return (int)cudaGetLastError();
}

// Columns per strip of the local kernel for paths of lp columns (the
// wrapper sizes the scratch planes from it).
extern "C" int sa_local_strip(int lp) {
  const int lpt = lp <= 4 * MAX_THREADS ? 4 : 16;
  const int threads = round_up((lp + lpt - 1) / lpt, 32);
  return (threads < MAX_THREADS ? threads : MAX_THREADS) * lpt;
}

// K5: reads (R, lr) against paths (P, lp), out (3, R, P) int32: best, end
// row, end column.  scratch holds 2 * pairs * lr int32 and
// may be null when lp <= sa_local_strip(lp).
extern "C" int sa_local_fwd(const void* reads, int R, int lr,
                            const void* paths, int P, int lp, void* out,
                            void* scratch, void* stream) {
  if (R <= 0 || P <= 0 || lr <= 0 || lp <= 0 || P > 65535)
    return (int)cudaErrorInvalidValue;
  const int strip_w = sa_local_strip(lp);
  if (lp > strip_w && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int lpt = lp <= 4 * MAX_THREADS ? 4 : 16;
  const int threads = strip_w / lpt;
  const int key_bits = bit_length((long long)lr + 2);
  const long long vmax = lr < lp ? lr : lp;
  const bool wide = ((vmax + 1) << key_bits) >= (1LL << 31);
  const dim3 grid(R, P);
  cudaStream_t st = (cudaStream_t)stream;
#define GF_LOCAL(LPT, KEY)                                                   \
  local_fwd_kernel<LPT, KEY><<<grid, threads, 0, st>>>(                      \
      (const int8_t*)reads, lr, (const int8_t*)paths, lp,                    \
      (int32_t*)out, (int32_t*)scratch, key_bits)
  if (lpt == 16) {
    if (wide) GF_LOCAL(16, long long); else GF_LOCAL(16, int);
  } else {
    if (wide) GF_LOCAL(4, long long); else GF_LOCAL(4, int);
  }
#undef GF_LOCAL
  return (int)cudaGetLastError();
}

// Words of the K4 workspace for R pairs of lr-row reads split over `parts`
// blocks each (pairs_fwd_kernel's layout).
extern "C" long long sa_pairs_workspace(int R, int lr, int parts) {
  const long long blocks = (long long)R * parts;
  const long long zeroed = (1 + R + blocks + 1) & ~1LL;
  return zeroed + 2 * blocks + blocks + blocks * lr;
}

// K4: reads (R, lr) against paths (R, lp), read p with path p; out (3, R)
// int32: best, end row, end column.  Each pair takes `parts` blocks of T
// threads (a multiple of 32, at most 512) of K columns (4, 8 or 16), with
// parts * T * K >= lp; work holds sa_pairs_workspace(R, lr, parts) int32.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int sa_pairs_fwd(const void* reads, int R, int lr,
                            const void* paths, int lp, void* out, void* work,
                            int K, int T, int parts, void* stream) {
  if (R <= 0 || lr <= 0 || lp <= 0 || work == nullptr || parts <= 0 ||
      (K != 4 && K != 8 && K != 16) || T < 32 || T % 32 || T > MAX_THREADS ||
      (long long)parts * T * K < lp || (long long)R * parts > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t zeroed = (size_t)((1 + R + (long long)R * parts + 1) & ~1LL);
  cudaError_t merr = cudaMemsetAsync(work, 0, zeroed * sizeof(int32_t), st);
  if (merr != cudaSuccess) return (int)merr;
  const int NW = T / 32;
  int a_ring_size = 64;  // a power of two >= 64 * NW + 64 rows in flight
  while (a_ring_size < 64 * NW + 64) a_ring_size *= 2;
  const size_t smem = (size_t)(a_ring_size + NW * HRING) * sizeof(int32_t);
  const bool wide = lr > KEY16_MAX_LR;
  const int blocks = R * parts;
  int err = 0;
#define GF_PAIRS(KK, KEY)                                                    \
  do {                                                                       \
    if ((err = prepare(pairs_fwd_kernel<KK, KEY>, smem))) return err;        \
    pairs_fwd_kernel<KK, KEY><<<blocks, T, smem, st>>>(                      \
        (const int8_t*)reads, lr, (const int8_t*)paths, lp, R, parts,        \
        (int32_t*)out, (int32_t*)work, a_ring_size);                         \
  } while (0)
  if (K == 4) {
    if (wide) GF_PAIRS(4, long long); else GF_PAIRS(4, int);
  } else if (K == 8) {
    if (wide) GF_PAIRS(8, long long); else GF_PAIRS(8, int);
  } else {
    if (wide) GF_PAIRS(16, long long); else GF_PAIRS(16, int);
  }
#undef GF_PAIRS
  return (int)cudaGetLastError();
}
