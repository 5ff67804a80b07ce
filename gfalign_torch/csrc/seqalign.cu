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
//                          product (every read against every path);
//   sa_walk (_rows, _tiles, _trace)
//                          the exact full-matrix traceback of one pair
//                          (walk codes, then the walk; in row blocks when
//                          the rectangle is large); replaces no TPU kernel:
//                          the JAX package walks on the host.
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
// (two block barriers a row).  The launcher sizes the strip for the
// launch's longest live read (rows), so a read of up to ~217 kb fits the
// card's 227 KB at a band of 2048 whatever the pool's padded width.
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

// The skewed wavefront that K4 (pairs_fwd_kernel) and the walk's forward
// pass (walk_fwd_kernel) share: full local alignment of one read against
// one path, the path's columns split over `parts` blocks of T threads, K
// columns a thread, no H matrix kept.
//   * inside a block the threads run K2's skewed wavefront
//     (csrc/nw_path.cu): lane l of warp w works on row s - l at step s with
//     its left column from lane l - 1 by one shuffle, so the horizontal
//     chain is serial and exact and needs no scan; warp w runs two batches
//     of 32 rows behind warp w - 1, its left column through a ring in
//     shared memory, one block barrier per 32 rows;
//   * between the blocks of a pair the last column goes through global
//     memory (hand_out: n_rows words a block, read by the next block as its
//     hand_in) with a progress word a block: block p publishes the rows it
//     has finished after each batch, block p + 1 waits for the rows of its
//     next batch.  The kernels place blocks by ticket (an atomic counter),
//     so a block only ever waits for one that is already running, whatever
//     order the card starts them in.
// The two kernels differ only in what they keep of a cell, which `epi`
// does: epi.cell(k, i, v, dg, up, left, eq) after cell (i, jbase + k + 1)
// of value v, with its diagonal, upper and left neighbours and eq the
// walk's match (read == path < 4, no PAD case), then epi.row(i) after the
// lane's K cells of row i.  The caller sets h to the lane's cells of row 0
// and passes H[0][jbase] as dg_init (zeros for K4; a boundary row for a
// block of the walk); column 0 is 0 in every row after row 0.  h ends as
// the lane's cells of row n_rows.
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

// One block's strip of the wavefront: columns jbase + 1.. of the thread,
// part `part` of `parts` (progress points at this block's word, the left
// block's before it), read chars staged through a_ring (amask + 1 words),
// the warps' hand-over through ring_h (NW * HRING words).
template <int K, typename Epi>
__device__ __forceinline__ void wavefront_strip(
    const int8_t* __restrict__ read, int n_rows,
    const int8_t* __restrict__ path, int lp, int jbase, int part, int parts,
    int32_t* progress, const int32_t* hand_in, int32_t* hand_out,
    int32_t* a_ring, int amask, int32_t* ring_h, int (&h)[K], int dg_init,
    Epi& epi) {
  const int t = threadIdx.x, w = t >> 5, l = t & 31;
  const int T = blockDim.x, NW = T >> 5;
  int pc[K];
  bool pad_col = false;  // a PAD column among the warp's (past the path)
#pragma unroll
  for (int k = 0; k < K; ++k) {
    pc[k] = jbase + k < lp ? path[jbase + k] : PAD;  // past the path: inert
    pad_col |= pc[k] == PAD;
  }
  pad_col = __any_sync(FULL, pad_col);
  const bool col0 = w == 0 && part == 0;  // lane 0 borders column 0
  int dg0 = dg_init;  // H[i-1][jbase]: the left column one row up
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
      const bool eq = pc[k] == rk;
      int s = eq ? s_match : s_mis;
      if (decltype(pads)::value && pc[k] == PAD) s = BLOCKV;
      const int up = h[k];
      const int c = __viaddmax_s32_relu(dg, s, up + GAP);
      const int v = __viaddmax_s32(left, GAP, c);
      epi.cell(k, i, v, dg, up, left, eq);
      dg = up;
      left = v;
      h[k] = v;
    }
    epi.row(i);
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
          while (load_acquire(progress - 1) < need) {
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
      if (rows_done > 0) store_release(progress, rows_done);
    }
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
//     split so that they still fill the card, many take a block each), and
//     run the wavefront above (wavefront_strip);
//   * a thread keeps the best key of each of its columns (BestKeys), each
//     block leaves its best (key, column); the last block of a pair to
//     finish reduces them, smaller column winning ties.
// Workspace (int32 words, see sa_pairs_workspace): ticket, done[R],
// progress[R * PARTS] (zeroed by the launcher), keys[R * PARTS] (int64),
// columns[R * PARTS], hand[R * PARTS * lr].
template <int K, typename KeyT>
struct BestKeys {
  KeyT key[K];
  __device__ __forceinline__ void cell(int k, int i, int v, int, int, int,
                                       bool) {
    constexpr int bits = sizeof(KeyT) == 4 ? 16 : 32;
    key[k] = max(key[k], (KeyT)v * ((KeyT)1 << bits) - i);
  }
  __device__ __forceinline__ void row(int) {}
};

template <int K, typename KeyT>
__global__ void __launch_bounds__(MAX_THREADS)
pairs_fwd_kernel(const int8_t* __restrict__ reads, int lr,
                 const int8_t* __restrict__ paths, int lp, int R, int parts,
                 int32_t* __restrict__ out, int32_t* work, int a_ring_size) {
  extern __shared__ int32_t sm[];
  __shared__ int ticket_s, rows_slot, red_x[MAX_WARPS];
  __shared__ KeyT red_k[MAX_WARPS];
  const int t = threadIdx.x;
  const int T = blockDim.x;
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
  const int jbase = (part * T + t) * K;  // the thread's columns: jbase + 1..
  constexpr int KEY_BITS = sizeof(KeyT) == 4 ? 16 : 32;
  constexpr KeyT KEY_SCALE = (KeyT)1 << KEY_BITS;
  BestKeys<K, KeyT> best;
#pragma unroll
  for (int k = 0; k < K; ++k) best.key[k] = 0;
  int h[K];
#pragma unroll
  for (int k = 0; k < K; ++k) h[k] = 0;
  wavefront_strip<K>(read, n_rows, path, lp, jbase, part, parts,
                     progress + ticket, hand + (size_t)(ticket - 1) * lr,
                     hand + (size_t)ticket * lr, sm, a_ring_size - 1,
                     sm + a_ring_size, h, 0, best);
  KeyT bk = 0;
  int bj = 0;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (best.key[k] > bk) {
      bk = best.key[k];
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
      int best_v = 0, bi = 0;
      if (best_k > 0) {
        best_v = (int)((best_k + KEY_SCALE - 1) >> KEY_BITS);
        bi = (int)((long long)best_v * KEY_SCALE - best_k);
      } else {
        best_j = 0;
      }
      out[pair] = best_v;
      out[R + pair] = bi;
      out[2 * R + pair] = best_j;
    }
  }
}

// The exact full-matrix traceback (sa_walk, sa_walk_rows, sa_walk_tiles,
// sa_walk_trace).  Replaces no TPU kernel: the JAX package walks on the host
// (gfalign_tpu/ops/seqalign.py traceback), as the port does on the CPU
// (seq_local_traceback in native/gfalign_host.cpp).  The align mode takes
// this walk when a banded walk fails its parity gates: one (read, path)
// pair, rows 1..end_i by columns 1..end_j, 0.3-2 G cells for a CLR read
// against its candidate path, tens of G cells for an ultra-long ONT read.
// Bit for bit seq_local_traceback: the matrix scores a PAD on either side
// as BLOCKV, the walk's diagonal test takes match iff read == path < 4 (no
// PAD case), a move is tried diagonal, then up, then left.  On CUDA every
// full walk of the align mode comes here (ops/seqalign.traceback); on the
// CPU the native walk stays the route and the oracle, and
// ops/seqalign.walk_codes_ref plus its walk is the plain version.
//
// Bound: integer ALU operations, 8 a cell for the recurrence (1 G cells
// take ~0.5 ms at 16.7 T int32 op/s) and about as many again for the walk
// code; the codes written, 2 bits a cell (cells / 4 bytes), take under a
// tenth of that at 3.35 TB/s.  The wavefront's steps are serial within a
// lane, so the kernel runs far from that bound (a few % at clr.align's
// sizes, PERF.md's kernel table): the design keeps as many lanes busy as
// the rectangle's width allows.
//
// The kernels work on tiles: rows r0 + 1 .. r0 + rows of the read against
// columns c0 + 1 .. c0 + cols of the path, from a top row H[r0][c0 ..] (a
// boundary row that the forward pass kept, or zeros), column c0 taken as 0.
// A launch computes a table of tiles side by side, `parts` blocks a tile.
//   * walk_fwd_kernel<true> runs K4's wavefront (wavefront_strip) over each
//     tile, WALK_K = 8 columns a lane, and keeps, for every cell, the 2-bit
//     move the host walk would take there (WalkCodes), decided while the
//     cell's neighbours are still in registers: 0 stop (H <= 0, or no move
//     fits), 1 diagonal (H == H[i-1][j-1] + sub, sub the match iff
//     read == path < 4), 2 up (I), 3 left (D), tried in that order.  No H
//     matrix is stored: the walk needs only the codes and the two
//     sequences.  A tile's blocks, two warps of 512 columns each, are
//     chained left to right by the progress words (block p + 1 runs ~100
//     rows behind block p).  The layout (ops/seqalign_cuda.walk_layout) is
//     the fastest of 4, 8 or 16 columns a lane and one to four warps a
//     block at clr.align's sizes: the step is serial within a lane, so more
//     lanes beat more columns a lane until the ramp (a warp's 32 rows of
//     skew and the batch of the hand-over, per block) eats the gain;
//   * code packing: a lane's 8 codes of a row are one 16-bit word, and
//     column group g of a tile (its columns c0 + 8 g + 1 .. c0 + 8 g + 8)
//     keeps its rows contiguous, codes[tile + g * rows + i - r0 - 1], so a
//     lane writes its words one after another (L2 merges the 2-byte writes
//     into whole sectors) and a stretch of the walk is a set of contiguous
//     runs;
//   * walk_trace_kernel, one block of WALK_TRACE_THREADS, walks from a cell
//     through the tiles of a launch: the block loads the codes above and
//     left of the walk's cell inside its tile (WALK_TROWS rows by
//     WALK_TGROUPS groups, 512 x 512 cells in 64 KB, with the read's and the
//     path's chars) into shared memory, thread 0 steps through them (one
//     shared load, a shift and a branch a step) until it leaves them, and
//     the block loads the next.  It keeps the walk's state in out[1..6]
//     (the cell, matches, nm, the op count, how the walk ended) and the
//     ops, last first, backwards from the end of the op area, so that they
//     read forward; a later launch goes on from that state.
//
// Memory.  A rectangle whose codes (cells / 4 bytes) fit the caller's
// budget is one tile: one forward launch with codes and one walk, as the
// walk has always run (clr.align's walks, up to ~1.4 G cells).  A larger
// one holds a bounded amount whatever its size (ops/seqalign_cuda's
// _launch_walk sizes it: 300 k x 600 k cells in under 1 GiB), in row blocks:
//   * walk_fwd_kernel<false>, the forward pass without codes over the whole
//     rectangle as one tile, keeps H's row every `every` rows (WalkRows: the
//     boundary rows) and the score s;
//   * the band: a walk that ends at (R, C) with score s has at most D
//     deletions and I insertions (ops/seqalign.walk_gaps, which counts its
//     moves), so each of its cells lies within diagonals C - R - D ..
//     C - R + I.  The count holds for the walk's own moves (a diagonal on a
//     PAD row counted as the -2 its test takes), so it bounds the walk
//     itself; ops/seqalign_cuda.walk_band cuts the row blocks to it.  The
//     row blocks between boundary rows, each cut to the band's columns,
//     are one launch of tiles with codes, and one trace walks through them.
//     A tile takes its left column as 0, not its true H, so its values can
//     only fall; on the walk's cells, and on each neighbour whose test
//     fits, they are exact, since each lies on a best alignment that the
//     band holds whole.  On a PAD cell the walk's -2 diagonal test could fit
//     a neighbour that the tile lowered, so the launcher takes the band only
//     for a rectangle without PAD;
//   * otherwise, or where the band's codes outgrow their budget, the row
//     blocks whole width, bottom block first, one launch with codes and one
//     trace a block, each from its boundary row and so with the forward
//     pass's exact values: the codes one tile would hold.
// Row blocks (Hirschberg's halving, or tiles of columns, would do as well
// for memory) because a row block is the one shape the wavefront already
// computes well: the full width keeps every lane busy, and the band's
// tiles are many small rectangles in one launch.
constexpr int WALK_K = 8;          // columns a lane: one word of 2-bit codes
using WalkWord = uint16_t;
constexpr int WALK_TROWS = 512;    // rows of the walk's tile in shared memory
constexpr int WALK_TGROUPS = 64;   // column groups of that tile
constexpr int WALK_TRACE_THREADS = 512;  // walk_trace_kernel's block
constexpr int WALK_HEAD = 8;       // int32 words of out before the ops
constexpr int WALK_TILE_WORDS = 6;  // int64 words of a tile's descriptor

// A tile: its first code word, rows r0 + 1 .. r0 + rows, columns
// c0 + 1 .. c0 + cols, and the boundary row that holds H[r0][*] (-1: zeros).
struct WalkTile {
  long long codes;
  int r0, rows, c0, cols, top;
};

// Tile k of a launch's table, or with no table the whole rows x cols.
__device__ __forceinline__ WalkTile walk_tile(const long long* tiles, int k,
                                              int rows, int cols) {
  if (tiles == nullptr) return WalkTile{0, 0, rows, 0, cols, -1};
  const long long* d = tiles + (size_t)WALK_TILE_WORDS * k;
  return WalkTile{d[0], (int)d[1], (int)d[2], (int)d[3], (int)d[4], (int)d[5]};
}

// The walk's per-cell work: the cell's move, 2 bits of the row's word
// (none for a lane whose columns lie past its tile: out is null).
struct WalkCodes {
  WalkWord* out;  // the lane's column group, the tile's first row first
  uint32_t word;
  __device__ __forceinline__ void cell(int k, int, int v, int dg, int up,
                                       int left, bool eq) {
    // the first move that fits in the walk's order
    uint32_t code = v == left + GAP ? 3u : 0u;
    code = v == up + GAP ? 2u : code;
    code = v == dg + (eq ? MATCH : MISMATCH) ? 1u : code;
    word |= (v > 0 ? code : 0u) << (2 * k);
  }
  __device__ __forceinline__ void row(int i) {
    if (out != nullptr) out[i - 1] = (WalkWord)word;
    word = 0;
  }
};

// The forward pass's boundary rows: H's row i for i = every, 2 every, ..,
// up to `last`, boundary row i / every - 1 (ld words a row, column 0 first).
struct WalkRows {
  int32_t* dst;  // the next boundary row at the lane's column jbase
  long long ld;
  int every, next, last, ncols;  // ncols: the lane's columns in the tile
  int v[WALK_K];
  __device__ __forceinline__ void cell(int k, int, int val, int, int, int,
                                       bool) {
    v[k] = val;
  }
  __device__ __forceinline__ void row(int i) {
    if (i != next) return;
    if (i <= last) {
#pragma unroll
      for (int k = 0; k < WALK_K; ++k)
        if (k < ncols) dst[k + 1] = v[k];
    }
    dst += ld;
    next += every;
  }
};

// The tiles of a launch, `parts` blocks a tile placed by ticket.  With CODES
// each tile's walk codes (WalkCodes); without, the one tile's boundary rows
// (WalkRows into bound_out).  A tile's top row is row `top` of `bound`.
// With `score`, the lane at the last column writes H[rows][cols] there.
template <bool CODES>
__global__ void __launch_bounds__(MAX_THREADS)
walk_fwd_kernel(const int8_t* __restrict__ read, const int8_t* __restrict__ path,
                int rows, int cols, const long long* __restrict__ tiles,
                int parts, const int32_t* bound, long long ld,
                WalkWord* __restrict__ codes, int32_t* bound_out, int every,
                int last, int32_t* work, int hand_rows,
                int32_t* __restrict__ score, int a_ring_size) {
  extern __shared__ int32_t sm[];
  __shared__ int ticket_s;
  const int t = threadIdx.x;
  if (t == 0) ticket_s = atomicAdd(work, 1);
  __syncthreads();
  const int ticket = ticket_s;
  const int part = ticket % parts;
  const WalkTile tile = walk_tile(tiles, ticket / parts, rows, cols);
  int32_t* progress = work + 1;
  int32_t* hand = work + 1 + gridDim.x;
  const int grp = part * blockDim.x + t;  // the lane's column group
  const int jbase = grp * WALK_K;         // its columns: jbase + 1..
  int h[WALK_K];
  int dg = 0;
  if (tile.top >= 0) {
    const int32_t* top = bound + (size_t)tile.top * ld + tile.c0;
#pragma unroll
    for (int k = 0; k < WALK_K; ++k)
      h[k] = jbase + k + 1 <= tile.cols ? top[jbase + k + 1] : 0;
    if (jbase <= tile.cols) dg = top[jbase];
  } else {
#pragma unroll
    for (int k = 0; k < WALK_K; ++k) h[k] = 0;
  }
  const int8_t* tread = read + tile.r0;
  const int8_t* tpath = path + tile.c0;
  const int32_t* hand_in = hand + (size_t)(ticket > 0 ? ticket - 1 : 0) * hand_rows;
  int32_t* hand_out = hand + (size_t)ticket * hand_rows;
  if constexpr (CODES) {
    WalkCodes epi{jbase < tile.cols
                      ? codes + tile.codes + (size_t)grp * tile.rows
                      : nullptr,
                  0u};
    wavefront_strip<WALK_K>(tread, tile.rows, tpath, tile.cols, jbase, part,
                            parts, progress + ticket, hand_in, hand_out, sm,
                            a_ring_size - 1, sm + a_ring_size, h, dg, epi);
  } else {
    WalkRows epi{bound_out + jbase, ld, every, every, last,
                 min(WALK_K, max(0, tile.cols - jbase)), {}};
    if (jbase == 0)  // column 0 of every boundary row
      for (int r = every; r <= last; r += every)
        bound_out[(size_t)(r / every - 1) * ld] = 0;
    wavefront_strip<WALK_K>(tread, tile.rows, tpath, tile.cols, jbase, part,
                            parts, progress + ticket, hand_in, hand_out, sm,
                            a_ring_size - 1, sm + a_ring_size, h, dg, epi);
  }
  if (score != nullptr) {
#pragma unroll
    for (int k = 0; k < WALK_K; ++k)  // every lane's last row is row `rows`
      if (jbase + k + 1 == tile.cols) *score = h[k];
  }
}

// The walk from (start_i, start_j) through the tiles of a launch (uniform
// row blocks, the first from row tiles[0].r0 + 1, the last possibly
// shorter), or with no table the whole rows x cols.  With `cont` it goes
// on from the state a launch before left in out.  Ends in out[6]: 1 the
// walk ended (a stop code, row 0 or column 0), 0 it left the launch's
// rows upwards (a block above goes on from out[1], out[2]), 2 it left a
// tile's columns.
__global__ void __launch_bounds__(WALK_TRACE_THREADS)
walk_trace_kernel(const WalkWord* __restrict__ codes,
                  const long long* __restrict__ tiles, int n_tiles, int rows,
                  int cols, const int8_t* __restrict__ read,
                  const int8_t* __restrict__ path, int32_t* __restrict__ out,
                  int cap, int start_i, int start_j, int cont) {
  extern __shared__ int32_t dyn[];
  __shared__ int cur_i, cur_j, status, cur_k;
  WalkWord* tile_sm = (WalkWord*)dyn;  // group-major: [gg * TROWS + rr]
  int8_t* tread = (int8_t*)(tile_sm + WALK_TROWS * WALK_TGROUPS);
  int8_t* tpath = tread + WALK_TROWS;
  char* ops = (char*)(out + WALK_HEAD);
  const int t = threadIdx.x;
  const WalkTile first = walk_tile(tiles, 0, rows, cols);
  int n = 0, matches = 0, nm = 0;  // thread 0's
  if (t == 0) {
    if (cont) {
      matches = out[3];
      nm = out[4];
      n = out[5];
    }
    cur_i = start_i;
    cur_j = start_j;
    status = start_i == 0 || start_j == 0 ? 1 : -1;
  }
  __syncthreads();
  for (;;) {
    if (t == 0 && status < 0) {
      const int i = cur_i, j = cur_j;
      if (i <= first.r0) {
        status = 0;  // above the launch's rows
      } else {
        const int k = min(n_tiles - 1, (i - 1 - first.r0) / max(1, first.rows));
        const WalkTile tl = walk_tile(tiles, k, rows, cols);
        if (j <= tl.c0 || j > tl.c0 + tl.cols || i > tl.r0 + tl.rows)
          status = 2;
        cur_k = k;
      }
    }
    __syncthreads();
    if (status >= 0) break;
    const WalkTile tl = walk_tile(tiles, cur_k, rows, cols);
    const int i = cur_i, j = cur_j;
    // the codes above and left of (i, j) in its tile: rows i_lo..i, the
    // tile's column groups g_lo..g_hi (columns j_lo + 1..j)
    const int i_lo = max(tl.r0 + 1, i - WALK_TROWS + 1);
    const int g_hi = (j - 1 - tl.c0) / WALK_K;
    const int g_lo = max(0, g_hi - WALK_TGROUPS + 1);
    const int j_lo = tl.c0 + g_lo * WALK_K;
    const int nr = i - i_lo + 1;
    const size_t row0 = (size_t)(i_lo - 1 - tl.r0);
#pragma unroll 8
    for (int q = t; q < WALK_TGROUPS * WALK_TROWS; q += WALK_TRACE_THREADS) {
      const int gg = q / WALK_TROWS, rr = q % WALK_TROWS;
      if (g_lo + gg <= g_hi && rr < nr)
        tile_sm[q] = __ldcg(codes + tl.codes + (size_t)(g_lo + gg) * tl.rows +
                            row0 + rr);
    }
    for (int q = t; q < nr; q += WALK_TRACE_THREADS) tread[q] = read[i_lo - 1 + q];
    for (int q = t; q < j - j_lo; q += WALK_TRACE_THREADS)
      tpath[q] = path[j_lo + q];
    __syncthreads();
    if (t == 0) {
      int ii = i, jj = j;
      bool stop = false;
      while (ii >= i_lo && jj > j_lo) {
        const int jt = jj - 1 - tl.c0;  // the cell's column in its tile
        const uint32_t word = tile_sm[(jt / WALK_K - g_lo) * WALK_TROWS + ii - i_lo];
        const uint32_t code = (word >> (2 * (jt % WALK_K))) & 3u;
        char op;
        if (code == 1u) {
          const int rc = tread[ii - i_lo];
          const bool eq = rc == tpath[jj - 1 - j_lo] && rc < 4;
          op = eq ? '=' : 'X';
          matches += eq;
          nm += !eq;
          --ii;
          --jj;
        } else if (code == 2u) {
          op = 'I';
          ++nm;
          --ii;
        } else if (code == 3u) {
          op = 'D';
          ++nm;
          --jj;
        } else {
          stop = true;  // a local start
          break;
        }
        ops[cap - 1 - n] = op;
        ++n;
      }
      cur_i = ii;
      cur_j = jj;
      if (stop || ii == 0 || jj == 0) status = 1;
    }
    __syncthreads();
  }
  if (t == 0) {
    if (!cont && tiles == nullptr && (rows == 0 || cols == 0))
      out[0] = 0;  // no forward pass ran
    out[1] = cur_i;
    out[2] = cur_j;
    out[3] = matches;
    out[4] = nm;
    out[5] = n;
    out[6] = status;
  }
}

// The banded walk (sa_bandtrace): the banded traceback of many (read, path)
// pairs in one launch.  Replaces no TPU kernel: the JAX package walks on the
// host (gfalign_tpu/ops/seqalign.py banded_traceback), as the port does on
// the CPU (seq_banded_traceback in native/gfalign_host.cpp).  The placement
// loop asks for a read's walks one at a time, since what a read's earlier
// walks accepted decides its next; it gathers the next walk of every read
// into a wave (engine/graph_align.placement_rounds), and a wave is one
// launch.  Bit for bit seq_banded_traceback: K3's banded recurrence (H[i][u]
// at j = i + delta - width/2 + u: the diagonal keeps its lane, 'up' comes
// from lane u + 1 and is blocked at the last lane, the chain seeds at 0,
// cells with j outside [1, end_j] are 0, a PAD on either side scores
// BLOCKV) over rows 1..end_i, then the walk from (end_i, u_end) behind the
// two parity gates: H[end_i][u_end] must equal the ladder's score, and no
// cell of the walk may lie on lane 0 or lane width - 1.  A walk that fails
// either is declined (the caller walks the full matrix instead).
//
// Bound: integer ALU operations, 8 a band cell for the recurrence and about
// as many again for the move codes; the codes, 2 bits a cell, are a tenth of
// that at 3.35 TB/s.  A walk's rows are a serial chain, so a wave takes at
// least its longest walk's rows times a row's latency: the design keeps a
// row short and a wave's walks in flight together.
//   * bandtrace_fwd_kernel: a walk is a TEAM of G threads of L lanes each
//     (ops/seqalign_cuda.bandtrace_layout: as many threads as cover the
//     band, up to 128, of 4 lanes each or the fewest more, a power of two),
//     K3's group kernel row for row: the strip in a ring in shared memory
//     refilled every 32 rows, the chain a segmented max-plus scan of the
//     team, across the warps of a team of 64 or 128 threads through shared
//     memory (scan_carry; the teams of a block then share its two barriers
//     a row).  A row's latency is about its thread's instructions, since a
//     wave's few long walks leave each scheduler one warp to issue: a row
//     of 16 lanes a thread took ~1,400 cycles, of 64 lanes ~4,500
//     (PERF.md), so a band spreads over more threads and warps before it
//     takes more lanes a thread.  Each cell's move, decided while its
//     neighbours are still in registers, is 2 bits of the row's code words,
//     as WalkCodes decides it: 0 stop (H <= 0, or no move fits), 1 diagonal
//     (H == H[i-1][u] + sub, sub the match iff read == path < 4), 2 up (I,
//     H == H[i-1][u+1] + gap), 3 left (D, H == H[i][u-1] + gap), the first
//     that fits.  Rows whose band lies inside the path and has no dead lane
//     skip the path mask.  A block is 128 threads of one (L, G); the
//     launcher gives a block's teams walks of like length and starts the
//     blocks of the longest walks first.  No H is kept: the walk reads only
//     the codes, the two sequences and the end cell's value;
//   * bandtrace_back_kernel, one warp a walk: the warp loads a stage of the
//     walk's codes (up to BT_TRACE_WORDS words: whole rows of a band up to
//     512 lanes, a window of 512 lanes around the walk of a wider one,
//     with the read's and the path's chars) into shared memory, thread 0
//     walks through it, and the warp loads the next stage, as
//     walk_trace_kernel does.  The ops go out 2 bits each, last first.
constexpr int BT_THREADS = 128;       // a block of bandtrace_fwd_kernel
constexpr int BT_TABLE_WORDS = 16;    // int64 words of a walk in the table
constexpr int BT_BLOCK_WORDS = 4;     // int32 words of a block in the table
constexpr int BT_HEAD = 8;            // int32 words of a result before its ops
constexpr int BT_TRACE_WORDS = 8192;  // code words a stage of the walk holds
constexpr int BT_TRACE_ROWS = 512;    // rows a stage holds, at most
// A band wider than BT_TRACE_SPAN words a row stages a window of that many
// around the walk, BT_TRACE_WIN_ROWS rows at a time: the walk moves right
// by at most a lane a row (I), so the window reaches that far right of it.
constexpr int BT_TRACE_SPAN = 32;
constexpr int BT_TRACE_WIN_ROWS = 128;
constexpr int BT_MAX_WIDTH = 8192;
// A walk's words in the table: chars offsets of its read (end_i chars) and
// of its path slice (path positions lo .. end_j - 1), lo, end_i, end_j,
// delta, width, its first code word, code words a row, its first result
// word, the ladder's score, the end lane, and the ops its result holds.
constexpr int BT_READ = 0, BT_PATH = 1, BT_LO = 2, BT_ROWS = 3, BT_PLEN = 4,
              BT_DELTA = 5, BT_WIDTH = 6, BT_CODES = 7, BT_STRIDE = 8,
              BT_RES = 9, BT_EXPECTED = 10, BT_UEND = 11, BT_CAP = 12;

// Ring bytes of a team of `span` lanes: K3's (sa_banded_ring).
__device__ __forceinline__ int bt_ring(int span) {
  int rb = 64;
  while (rb < (span + 36 + 31) / 32 * 32 + 4) rb *= 2;
  return rb;
}

// The forward pass of the teams of one block: walks first .. first +
// n_teams - 1 of the table, G threads of L lanes each.
template <int L>
__device__ __forceinline__ void bandtrace_team(
    const int8_t* __restrict__ chars, const long long* __restrict__ table,
    int first, int n_teams, int G, uint32_t* __restrict__ codes,
    int32_t* __restrict__ res, uint32_t* ring_base, int* wtot, int* xch,
    int* vote, int* block_rows) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool multi = G > 32;              // a team of several warps
  const int t = tid % G;                  // thread in the team
  const int grp = tid / G;                // team in the block
  const int nw = multi ? G >> 5 : 1;      // warps of a team
  const int tw = warp % nw;               // the warp in its team
  const bool valid = grp < n_teams;       // a team past them runs idle
  const long long* w =
      table + (size_t)(first + (valid ? grp : 0)) * BT_TABLE_WORDS;
  const int8_t* read = chars + w[BT_READ];
  const int8_t* path = chars + w[BT_PATH];
  const int lo = (int)w[BT_LO], plen = (int)w[BT_PLEN];
  const int rows = valid ? (int)w[BT_ROWS] : 0;
  const int delta = (int)w[BT_DELTA], width = (int)w[BT_WIDTH];
  const int W2 = width / 2, u_end = (int)w[BT_UEND];
  const int stride = (int)w[BT_STRIDE];
  uint32_t* out = codes + w[BT_CODES];
  int32_t* end_value = res + w[BT_RES] + 1;
  // every team of a warp loops to the warp's longest, and teams of several
  // warps to the block's (they share its barriers)
  int wrows = rows;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    wrows = max(wrows, __shfl_xor_sync(FULL, wrows, d));
  if (multi) {
    if (tid == 0) *block_rows = 0;
    __syncthreads();
    if (lane == 0) atomicMax(block_rows, wrows);
    __syncthreads();
    wrows = *block_rows;
  }
  const int span = G * L;  // the team's lanes; those past width are dead
  const int ring_bytes = bt_ring(span);
  uint32_t* ring32 = ring_base + (size_t)grp * (ring_bytes / 4);
  int8_t* ring = (int8_t*)ring32;
  const int bmask = ring_bytes - 1, wmask = ring_bytes / 4 - 1;
  auto sync = [&]() {
    if (multi)
      __syncthreads();
    else
      __syncwarp();
  };
  // strip position p (path position p + delta - W2) lives at ring[p & bmask]
  auto fill = [&](int p0, int count) {
    for (int q = t; q < count; q += G) {
      const int x = p0 + q + delta - W2;
      ring[(p0 + q) & bmask] = (x >= 0 && x < plen) ? path[x - lo] : (int8_t)PAD;
    }
  };
  // a row i reads strip positions [i - 1, i + span + 3): before the chunk
  // of rows (c0, c0 + 32] the ring holds [c0 + filled - ring_bytes,
  // c0 + filled)
  const int filled = (span + 36 + 31) / 32 * 32;
  fill(0, filled);
  sync();

  const int u0 = t * L;
  int h[L];
#pragma unroll
  for (int k = 0; k < L; ++k) h[k] = 0;
  if (multi) {  // row 0 of the lanes that neighbouring warps exchange
    if (lane == 0) xch[warp] = 0;
    __syncthreads();
  }
  int r_next = rows > 0 ? read[0] : PAD;
  // row i's codes: the thread's 2 L bits, L / 16 words (a half or a byte of
  // one for L = 8 or 4), in lane order, little-endian
  constexpr int CW = L >= 16 ? L / 16 : 1;
  auto put = [&](int i, const uint32_t* cw) {
    uint32_t* dst = out + (size_t)(i - 1) * stride;
    if constexpr (L >= 16) {
#pragma unroll
      for (int q = 0; q < CW; ++q) dst[t * CW + q] = cw[q];
    } else if constexpr (L == 8) {
      ((uint16_t*)dst)[t] = (uint16_t)cw[0];
    } else {
      ((uint8_t*)dst)[t] = (uint8_t)cw[0];
    }
  };
  auto row = [&](auto masked, int i) {
    constexpr bool MASK = decltype(masked)::value;
    const int r = r_next;
    r_next = i < rows ? read[i] : PAD;  // the rows past a team's own are PAD
    // this row's window strip[i-1+u0 .. +L), four chars per word
    const int o = i - 1 + u0;
    const int wi = o >> 2, sh = (o & 3) * 8;
    uint32_t pk[L / 4];
    uint32_t lo_word = ring32[wi & wmask];
#pragma unroll
    for (int q = 0; q < L / 4; ++q) {
      const uint32_t hi = ring32[(wi + q + 1) & wmask];
      pk[q] = __funnelshift_r(lo_word, hi, sh);
      lo_word = hi;
    }
    // 'up' of the thread's last lane: the next thread's first lane (none
    // for the team's last thread, whose last lane is dead or the band's
    // last, blocked)
    int upn;
    if (multi) {
      upn = __shfl_down_sync(FULL, h[0], 1);
      if (lane == 31) upn = tw + 1 < nw ? xch[warp + 1] : NEG;
    } else {
      upn = __shfl_down_sync(FULL, h[0], 1, G);
      if (t == G - 1) upn = NEG;
    }
    const int s_match = r == PAD ? BLOCKV : MATCH;
    const int s_mis = r == PAD ? BLOCKV : MISMATCH;
    const int rk = r < 4 ? r : 0xff;  // N and PAD match nothing
    const int jb = i + delta - W2 + u0;  // j of the thread's first lane
    auto inside = [&](int k) {
      return (unsigned)(jb + k - 1) < (unsigned)plen && u0 + k < width;
    };
    int hv[L];
    int run = NEG;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int p = (int)((pk[k >> 2] >> ((k & 3) * 8)) & 0xffu);
      const int s = p == PAD ? BLOCKV : (p == rk ? s_match : s_mis);
      const int up = k + 1 < L ? h[k + 1] : upn;
      int c = __viaddmax_s32_relu(h[k], s, up + GAP);
      if (MASK && !inside(k)) c = 0;
      run = __viaddmax_s32(run, GAP, c);
      hv[k] = run;
    }
    // carry into this thread: the chain's value at the team's previous
    // thread's last lane, which is also that lane's H (the left neighbour
    // of the thread's first lane)
    int carry;
    if (multi) {
      carry = scan_carry(run, -GAP * L, NEG, lane, tw, nw, wtot + grp * nw);
    } else {
      int sc = run;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        if (d < G) {  // G is the block's
          const int ov = __shfl_up_sync(FULL, sc, d, G);
          if (t >= d) sc = max(sc, ov + GAP * L * d);
        }
      }
      carry = __shfl_up_sync(FULL, sc, 1, G);
      carry = t > 0 ? carry : NEG;
    }
    uint32_t cw[CW];
#pragma unroll
    for (int q = 0; q < CW; ++q) cw[q] = 0;
    int left = carry;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      int hn = __viaddmax_s32(carry, GAP * (k + 1), hv[k]);
      if (MASK && !inside(k)) hn = 0;
      const int p = (int)((pk[k >> 2] >> ((k & 3) * 8)) & 0xffu);
      const int up = k + 1 < L ? h[k + 1] : upn;
      // the first move that fits in the walk's order
      uint32_t code = hn == left + GAP ? 3u : 0u;
      code = hn == up + GAP ? 2u : code;
      code = hn == h[k] + (p == rk ? MATCH : MISMATCH) ? 1u : code;
      cw[k >> 4] |= (hn > 0 ? code : 0u) << (2 * (k & 15));
      left = hn;
      hv[k] = hn;
    }
#pragma unroll
    for (int k = 0; k < L; ++k) h[k] = hv[k];
    if (i <= rows) {
      put(i, cw);
      if (i == rows) {
#pragma unroll
        for (int k = 0; k < L; ++k)
          if (u0 + k == u_end) *end_value = h[k];
      }
    }
    if (multi) {
      if (lane == 0) xch[warp] = h[0];
      __syncthreads();
    }
  };
  for (int c0 = 0; c0 < wrows; c0 += RING_CHUNK) {
    if (c0 > 0) {
      sync();  // the previous chunk's reads are done
      fill(filled + c0 - RING_CHUNK, RING_CHUNK);
      sync();
    }
    const int c1 = min(c0 + RING_CHUNK, wrows);
    const int last = min(c1, rows);
    // A row of PAD read chars after a row of zeros is zeros (a PAD blocks
    // the diagonal; up and left only decay), its moves all stop: a chunk
    // whose rows up to the team's own last are PAD after a zero row (the
    // masked stretches of a read that earlier rounds placed) writes stop
    // codes and skips its rows.  Uniform over the warp, and over the block
    // for teams of several warps.
    bool zero = true;
#pragma unroll
    for (int k = 0; k < L; ++k) zero = zero && h[k] == 0;
    for (int i = c0 + 1 + t; i <= last; i += G) zero = zero && read[i - 1] == PAD;
    bool skip = !__any_sync(FULL, !zero);
    if (multi) {
      if (lane == 0) vote[warp] = skip;
      __syncthreads();
      for (int w = 0; w < BT_THREADS / 32; ++w) skip = skip && vote[w];
    }
    if (skip) {
      const uint32_t none[CW] = {};
      for (int i = c0 + 1; i <= last; ++i) put(i, none);
      if (c0 < rows && rows <= c1) *end_value = 0;
      r_next = c1 < rows ? read[c1] : PAD;
      continue;
    }
    // the mask can change a value only where a lane is dead or off the
    // path: every row of the chunk up to the team's own last within
    // j in [1, end_j] skips it (warp-uniform: the warp's teams agree)
    const bool plain = span == width &&
                       (last <= c0 || (c0 + 1 + delta - W2 >= 1 &&
                                       last + delta - W2 + width - 1 <= plen));
    if (__any_sync(FULL, !plain)) {
      for (int i = c0 + 1; i <= c1; ++i) row(std::true_type{}, i);
    } else {
      for (int i = c0 + 1; i <= c1; ++i) row(std::false_type{}, i);
    }
  }
}

__global__ void __launch_bounds__(BT_THREADS)
bandtrace_fwd_kernel(const int8_t* __restrict__ chars,
                     const long long* __restrict__ table,
                     const int32_t* __restrict__ blocks,
                     uint32_t* __restrict__ codes, int32_t* __restrict__ res) {
  extern __shared__ int32_t dyn[];
  __shared__ int wtot[MAX_WARPS], xch[MAX_WARPS], vote[MAX_WARPS], block_rows;
  const int32_t* b = blocks + (size_t)BT_BLOCK_WORDS * blockIdx.x;
  const int first = b[0], n_teams = b[1], lanes = b[2], G = b[3];
  uint32_t* ring = (uint32_t*)dyn;
  if (lanes == 4)
    bandtrace_team<4>(chars, table, first, n_teams, G, codes, res, ring, wtot,
                      xch, vote, &block_rows);
  else if (lanes == 8)
    bandtrace_team<8>(chars, table, first, n_teams, G, codes, res, ring, wtot,
                      xch, vote, &block_rows);
  else if (lanes == 16)
    bandtrace_team<16>(chars, table, first, n_teams, G, codes, res, ring, wtot,
                       xch, vote, &block_rows);
  else if (lanes == 32)
    bandtrace_team<32>(chars, table, first, n_teams, G, codes, res, ring, wtot,
                       xch, vote, &block_rows);
  else
    bandtrace_team<64>(chars, table, first, n_teams, G, codes, res, ring, wtot,
                       xch, vote, &block_rows);
}

// The walk of table row blockIdx.x over its codes: result words (BT_HEAD)
// how it ended (1 done, 2 declined by a gate, 3 out of op room), the end
// cell's value, qstart, pstart, matches, nm, the op count n; then the ops,
// 2 bits each ('=' 0, 'X' 1, 'I' 2, 'D' 3), op m in bits 2 (m % 16) of
// word m / 16, the last op of the alignment first.
__global__ void __launch_bounds__(32)
bandtrace_back_kernel(const int8_t* __restrict__ chars,
                      const long long* __restrict__ table,
                      const uint32_t* __restrict__ codes,
                      int32_t* __restrict__ res) {
  extern __shared__ int32_t dyn[];
  __shared__ int st_i, st_u, st_status;
  const long long* w = table + (size_t)BT_TABLE_WORDS * blockIdx.x;
  const int8_t* read = chars + w[BT_READ];
  const int8_t* path = chars + w[BT_PATH];
  const int lo = (int)w[BT_LO], plen = (int)w[BT_PLEN];
  const int rows = (int)w[BT_ROWS], delta = (int)w[BT_DELTA];
  const int width = (int)w[BT_WIDTH], W2 = width / 2;
  const int stride = (int)w[BT_STRIDE], cap = (int)w[BT_CAP];
  const uint32_t* cw = codes + w[BT_CODES];
  int32_t* out = res + w[BT_RES];
  uint32_t* ops = (uint32_t*)(out + BT_HEAD);
  uint32_t* tile = (uint32_t*)dyn;
  int8_t* tread = (int8_t*)(tile + BT_TRACE_WORDS);
  int8_t* tpath = tread + BT_TRACE_ROWS;
  const bool window = stride > BT_TRACE_SPAN;
  const int trows = window ? BT_TRACE_WIN_ROWS
                           : min(BT_TRACE_ROWS, BT_TRACE_WORDS / stride);
  const int t = threadIdx.x;
  int n = 0, matches = 0, nm = 0;  // thread 0's
  uint32_t word = 0;
  if (t == 0) {
    if (rows == 0) out[1] = 0;  // no forward row: H[0][*] = 0
    st_i = rows;
    st_u = (int)w[BT_UEND];
    st_status = out[1] == (int)w[BT_EXPECTED] ? -1 : 2;  // the first gate
  }
  __syncthreads();
  while (st_status < 0) {
    // the stage: rows i_lo..i by words g_lo..g_lo + ng - 1 of their codes
    // (lanes 16 g_lo ..), their read chars and the path chars of those
    // lanes (path index i_lo - 1 + delta - W2 + 16 g_lo + q at tpath[q])
    const int i = st_i;
    const int i_lo = max(1, i - trows + 1), nr = i - i_lo + 1;
    const int g_lo = window ? max(0, min(stride - 1, (st_u + trows) >> 4) -
                                         BT_TRACE_SPAN + 1)
                            : 0;
    const int ng = window ? BT_TRACE_SPAN : stride;
    const long long x0 = (long long)i_lo - 1 + delta - W2 + 16 * g_lo;
    // ng is a power of two: a thread loads word t % ng of every 32 / ng-th
    // row, eight loads in flight before their stores
    const uint32_t* src = cw + (size_t)(i_lo - 1) * stride + g_lo + t % ng;
    const int step = ng < 32 ? 32 / ng : 1;
    for (int r0 = t / ng; r0 < nr; r0 += 8 * step) {
      uint32_t v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (r0 + k * step < nr) v[k] = __ldcg(src + (size_t)(r0 + k * step) * stride);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (r0 + k * step < nr) tile[(r0 + k * step) * ng + t % ng] = v[k];
    }
    for (int q = t; q < nr; q += 32) tread[q] = read[i_lo - 1 + q];
    for (int q = t; q < nr + 16 * ng; q += 32) {
      const long long x = x0 + q;
      tpath[q] = (x >= 0 && x < plen) ? path[x - lo] : (int8_t)PAD;
    }
    __syncthreads();
    if (t == 0) {
      int ii = i, u = st_u, status = -1;
      for (;;) {
        if (u <= 0 || u >= width - 1) {
          status = 2;  // the walk touched the band's edge
          break;
        }
        if (ii == 0) {
          status = 1;
          break;
        }
        if (ii < i_lo || (u >> 4) < g_lo || (u >> 4) >= g_lo + ng)
          break;  // out of the stage
        const uint32_t code =
            (tile[(ii - i_lo) * ng + (u >> 4) - g_lo] >> (2 * (u & 15))) & 3u;
        if (code == 0u) {
          status = 1;  // a local start
          break;
        }
        if (n >= cap) {
          status = 3;
          break;
        }
        uint32_t op;
        if (code == 1u) {
          const int rc = tread[ii - i_lo];
          const bool eq = rc == tpath[ii - i_lo + u - 16 * g_lo] && rc < 4;
          op = eq ? 0u : 1u;
          matches += eq;
          nm += !eq;
          --ii;
        } else if (code == 2u) {
          op = 2u;
          ++nm;
          --ii;
          ++u;
        } else {
          op = 3u;
          ++nm;
          --u;
        }
        word |= op << (2 * (n & 15));
        if ((++n & 15) == 0) {
          ops[(n >> 4) - 1] = word;
          word = 0;
        }
      }
      st_i = ii;
      st_u = u;
      st_status = status;
    }
    __syncthreads();
  }
  if (t == 0) {
    if (n & 15) ops[n >> 4] = word;
    out[0] = st_status;
    out[2] = st_i;
    out[3] = max(0, st_i + delta - W2 + st_u);
    out[4] = matches;
    out[5] = nm;
    out[6] = n;
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
// max_rows (<= lr) bounds every pair's rows: the block kernel's strip in
// shared memory is sized by it.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int sa_banded_fwd(const void* arena, int arena_len,
                             const void* cum_off, const void* base_ptr,
                             const void* plen, int n_paths, int S,
                             const void* read_pool, int n_reads, int lr,
                             const void* read_idx, const void* path_idx,
                             const void* deltas, const void* order,
                             const void* rows, void* out, int N, int width,
                             int lanes, int group, int max_rows,
                             void* stream) {
  if (N <= 0 || arena_len <= 0 || n_paths <= 0 || S <= 0 || n_reads <= 0 ||
      lr <= 0 || (lanes != 4 && lanes != 16) || width < lanes ||
      width % lanes || max_rows < 0 || max_rows > lr)
    return (int)cudaErrorInvalidValue;
  const int key_bits = bit_length((long long)lr + 2);
  const bool wide = ((long long)(lr + 1) << key_bits) >= (1LL << 31);
  cudaStream_t st = (cudaStream_t)stream;
  int err = 0;
  if (group == 0) {
    if (width / lanes > MAX_THREADS) return (int)cudaErrorInvalidValue;
    const int threads = round_up(width / lanes, 32);
    const size_t smem = (size_t)2 * S * sizeof(int32_t) +
                        round_up(max_rows + threads * lanes + 8, 4);
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

// Words of a walk launch's workspace for `blocks` blocks that hand over
// `hand_rows` rows each: a ticket, a progress word a block, a hand-over
// column a block.
extern "C" long long sa_walk_workspace(int hand_rows, int blocks) {
  return 1 + (long long)blocks + (long long)blocks * hand_rows;
}

// The walk's layout constants, which ops/seqalign_cuda.py checks its own
// against: columns a lane of walk_fwd_kernel (WALK_K), int32 words of out
// before the ops (WALK_HEAD) and int64 words of a tile (WALK_TILE_WORDS).
extern "C" int sa_walk_k() { return WALK_K; }
extern "C" int sa_walk_head() { return WALK_HEAD; }
extern "C" int sa_walk_tile_words() { return WALK_TILE_WORDS; }

namespace {

int walk_ring(int T) {
  int a_ring_size = 64;  // a power of two >= 64 * NW + 64 rows in flight
  while (a_ring_size < 64 * (T / 32) + 64) a_ring_size *= 2;
  return a_ring_size;
}

bool walk_threads_ok(int T) { return T >= 32 && T % 32 == 0 && T <= MAX_THREADS; }

// One forward launch: n_tiles tiles of `parts` blocks of T threads.
template <bool CODES>
int walk_fwd(const void* read, const void* path, int rows, int cols,
             const void* tiles, int n_tiles, int parts, const void* bound,
             long long ld, void* codes, void* bound_out, int every, int last,
             void* work, int hand_rows, void* score, int T, cudaStream_t st) {
  const long long blocks = (long long)n_tiles * parts;
  cudaError_t merr =
      cudaMemsetAsync(work, 0, (1 + (size_t)blocks) * sizeof(int32_t), st);
  if (merr != cudaSuccess) return (int)merr;
  const int a_ring_size = walk_ring(T);
  const size_t smem = (size_t)(a_ring_size + (T / 32) * HRING) * sizeof(int32_t);
  int err = prepare(walk_fwd_kernel<CODES>, smem);
  if (err) return err;
  walk_fwd_kernel<CODES><<<(unsigned)blocks, T, smem, st>>>(
      (const int8_t*)read, (const int8_t*)path, rows, cols,
      (const long long*)tiles, parts, (const int32_t*)bound, ld,
      (WalkWord*)codes, (int32_t*)bound_out, every, last, (int32_t*)work,
      hand_rows, (int32_t*)score, a_ring_size);
  return (int)cudaGetLastError();
}

int walk_trace(const void* codes, const void* tiles, int n_tiles, int rows,
               int cols, const void* read, const void* path, void* out,
               int cap, int start_i, int start_j, int cont, cudaStream_t st) {
  const size_t smem = (size_t)WALK_TROWS * WALK_TGROUPS * sizeof(WalkWord) +
                      WALK_TROWS + WALK_TGROUPS * WALK_K;
  int err = prepare(walk_trace_kernel, smem);
  if (err) return err;
  walk_trace_kernel<<<1, WALK_TRACE_THREADS, smem, st>>>(
      (const WalkWord*)codes, (const long long*)tiles, n_tiles, rows, cols,
      (const int8_t*)read, (const int8_t*)path, (int32_t*)out, cap, start_i,
      start_j, cont);
  return (int)cudaGetLastError();
}

}  // namespace

// The exact full-matrix traceback of read (rows,) int8 against path (cols,)
// int8 from their last cell (rows, cols), as one tile.  codes holds
// ceil(cols / WALK_K) * rows 16-bit words, work sa_walk_workspace(rows,
// parts); out holds WALK_HEAD + (rows + cols + 3) / 4 int32: score, qstart,
// pstart, matches, nm, the op count n, how the walk ended (1), one unused
// word, then rows + cols bytes whose last n are the ops ('=', 'X', 'I',
// 'D'), forward.  T threads a block (a multiple of 32, at most 512),
// parts * T * WALK_K >= cols (ops/seqalign_cuda.walk_layout picks them).
// An empty rectangle launches the walk alone.  Launches on `stream` and
// returns the first launch error.
extern "C" int sa_walk(const void* read, int rows, const void* path, int cols,
                       void* codes, void* work, void* out, int T, int parts,
                       void* stream) {
  const bool cells = rows > 0 && cols > 0;
  if (rows < 0 || cols < 0 || out == nullptr || !walk_threads_ok(T) ||
      parts <= 0 || (long long)parts * T * WALK_K < cols ||
      (cells && (read == nullptr || path == nullptr || codes == nullptr ||
                 work == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (cells) {
    int err = walk_fwd<true>(read, path, rows, cols, nullptr, 1, parts,
                             nullptr, 0, codes, nullptr, 0, 0, work, rows,
                             out, T, st);
    if (err) return err;
  }
  return walk_trace(codes, nullptr, 1, rows, cols, read, path, out,
                    rows + cols, rows, cols, 0, st);
}

// The forward pass of a blocked walk, the rectangle as one tile without
// codes: H's rows every, 2 every, .. up to `last` (< rows) into bound (ld
// >= cols + 1 int32 a row, column 0 first), H[rows][cols] into out[0].
// work holds sa_walk_workspace(rows, parts).  Launches on `stream`.
extern "C" int sa_walk_rows(const void* read, int rows, const void* path,
                            int cols, int every, int last, void* bound,
                            long long ld, void* work, void* out, int T,
                            int parts, void* stream) {
  if (rows <= 0 || cols <= 0 || every <= 0 || last >= rows || ld < cols + 1 ||
      !walk_threads_ok(T) || parts <= 0 ||
      (long long)parts * T * WALK_K < cols || read == nullptr ||
      path == nullptr || work == nullptr || out == nullptr ||
      (last >= every && bound == nullptr))
    return (int)cudaErrorInvalidValue;
  return walk_fwd<false>(read, path, rows, cols, nullptr, 1, parts, nullptr,
                         ld, nullptr, bound, every, last, work, rows, out, T,
                         (cudaStream_t)stream);
}

// The walk codes of n_tiles tiles (tiles: n_tiles x WALK_TILE_WORDS int64 on
// the device: first code word, r0, rows, c0, cols, top) of read against
// path, each from its top row in bound (ld int32 a row) and `parts` blocks
// of T threads (parts * T * WALK_K >= every tile's cols, hand_rows >= every
// tile's rows); work holds sa_walk_workspace(hand_rows, n_tiles * parts).
// Launches on `stream`.
extern "C" int sa_walk_tiles(const void* read, const void* path,
                             const void* tiles, int n_tiles, int parts,
                             const void* bound, long long ld, void* codes,
                             void* work, int hand_rows, int T, void* stream) {
  if (n_tiles <= 0 || parts <= 0 || hand_rows <= 0 || !walk_threads_ok(T) ||
      (long long)n_tiles * parts > (1LL << 30) || read == nullptr ||
      path == nullptr || tiles == nullptr || codes == nullptr ||
      work == nullptr)
    return (int)cudaErrorInvalidValue;
  return walk_fwd<true>(read, path, 0, 0, tiles, n_tiles, parts, bound, ld,
                        codes, nullptr, 0, 0, work, hand_rows, nullptr, T,
                        (cudaStream_t)stream);
}

// The walk from (start_i, start_j) through the codes of n_tiles tiles
// (sa_walk_tiles'), going on from out's state with `cont`; out as sa_walk's,
// cap = the rectangle's rows + cols.  Launches on `stream`.
extern "C" int sa_walk_trace(const void* codes, const void* tiles, int n_tiles,
                             const void* read, const void* path, void* out,
                             int cap, int start_i, int start_j, int cont,
                             void* stream) {
  if (n_tiles <= 0 || tiles == nullptr || codes == nullptr || read == nullptr ||
      path == nullptr || out == nullptr || start_i < 0 || start_j < 0 ||
      start_i + start_j > cap)
    return (int)cudaErrorInvalidValue;
  return walk_trace(codes, tiles, n_tiles, 0, 0, read, path, out, cap,
                    start_i, start_j, cont, (cudaStream_t)stream);
}

// The banded walk's layout constants, which ops/seqalign_cuda.py checks its
// own against: int64 words of a walk in the table, int32 words of a block
// in the table, int32 words of a result before its ops.
extern "C" int sa_bandtrace_table_words() { return BT_TABLE_WORDS; }
extern "C" int sa_bandtrace_block_words() { return BT_BLOCK_WORDS; }
extern "C" int sa_bandtrace_head() { return BT_HEAD; }

// The banded walks of one launch: n_walks rows of table (BT_TABLE_WORDS
// int64 each, offsets into chars, codes and res as bandtrace_team reads
// them), n_blocks rows of blocks (BT_BLOCK_WORDS int32 each: first walk,
// teams, lanes L in {16, 32, 64}, team threads G, a power of two up to 32
// or 128), every walk in exactly one block's teams; codes holds each walk's
// end_i rows of `stride` words, res each walk's BT_HEAD words and its ops
// (bandtrace_back_kernel); max_width bounds every walk's width.  All on one
// device.  Launches the forward pass and the walks on `stream`, and returns
// the first launch error.
extern "C" int sa_bandtrace(const void* chars, const void* table, int n_walks,
                            const void* blocks, int n_blocks, void* codes,
                            void* res, int max_width, void* stream) {
  if (n_walks <= 0 || n_blocks <= 0 || max_width < 4 ||
      max_width > BT_MAX_WIDTH || chars == nullptr || table == nullptr ||
      blocks == nullptr || codes == nullptr || res == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  size_t ring_smem = 0;  // the most any layout's teams of a block hold
  for (int span = 16; span <= BT_MAX_WIDTH; span *= 2) {
    int rb = 64;
    while (rb < (span + 36 + 31) / 32 * 32 + 4) rb *= 2;
    // a team of span / 4 threads at most (4 lanes a thread)
    const int teams = span < 4 * BT_THREADS ? BT_THREADS / (span / 4) : 1;
    if ((size_t)teams * rb > ring_smem) ring_smem = (size_t)teams * rb;
  }
  int err = prepare(bandtrace_fwd_kernel, ring_smem);
  if (err) return err;
  bandtrace_fwd_kernel<<<n_blocks, BT_THREADS, ring_smem, st>>>(
      (const int8_t*)chars, (const long long*)table, (const int32_t*)blocks,
      (uint32_t*)codes, (int32_t*)res);
  err = (int)cudaGetLastError();
  if (err) return err;
  const size_t trace_smem = (size_t)BT_TRACE_WORDS * sizeof(uint32_t) +
                            2 * BT_TRACE_ROWS + 16 * BT_TRACE_SPAN;
  if ((err = prepare(bandtrace_back_kernel, trace_smem))) return err;
  bandtrace_back_kernel<<<n_walks, 32, trace_smem, st>>>(
      (const int8_t*)chars, (const long long*)table, (const uint32_t*)codes,
      (int32_t*)res);
  return (int)cudaGetLastError();
}
