// NW path-alignment scores for Hopper (sm_90a): the two kernels of the
// search/evalPath scorer, built by gfalign_torch/ops/nw_cuda.py with nvcc
// into a shared library with a plain C interface and loaded with ctypes.
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
// Design.  One thread owns one (candidate, read) pair and runs the ROW
// recurrence with j serial inside the thread, so the horizontal dependency
// needs no scan.  A block is one candidate x TILE_R reads: the candidate's
// keys are staged once in shared memory (every thread reads the same word,
// a broadcast), and read keys come in transposed, (m, R), so that
// neighbouring threads load neighbouring addresses.  A strip of MT columns
// (dp row, E row, read keys) lives in registers; reads wider than the
// widest strip (32) are swept strip by strip, each strip handing its last
// column to the next through a global scratch plane laid out
// [row][thread] (coalesced).
//
// What bounds it: integer ALU instructions.  The inputs and the output are
// a few MB at search shapes, while every DP cell costs a handful of int32
// instructions (compare, select, adds, two maxes, and for K1 a mask), so
// the bound is useful cells x ALU operations per cell / the ALU pipe's
// rate; chip_smoke.py (OPS_PER_CELL) counts them from the loops below.  The
// row chain (left -> max -> next left) is serial inside a thread; latency
// is hidden by the many independent (candidate, read) threads in flight.
//
// K1 packs dp, the walk's move priority and E into one int32,
//     ((dp + OFF) << S) | (prio << E_BITS) | E,
// so that one max selects the dp value first, then the walk's priority
// (diagonal 3 > up 2 > left 1; up drops to 0 in a free column, where the
// reference compares RAW predecessors and so prefers left on a tie), with
// E riding along in the low bits.  The bit budget needs
// S + bit_length(OFF + 1) < 31; the launcher refuses shapes beyond it,
// which is why K2 carries dp and E as separate words.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_R = 128;  // reads per block
constexpr int STRIP = 32;    // widest register strip

__device__ __forceinline__ int32_t row0_dp(int j, int a_len) {
  return j <= a_len ? -j : 0;  // the row-0 extent quirk: over A's extent
}

template <int MT>
__global__ void __launch_bounds__(TILE_R)
nw_fwd_packed_kernel(const int32_t* __restrict__ a_keys,
                     const int32_t* __restrict__ a_len_arr,
                     const int32_t* __restrict__ b_keys_t,
                     const int32_t* __restrict__ b_len_arr,
                     int32_t* __restrict__ out,
                     int32_t* __restrict__ scratch,
                     int n, int R, int m, int e_bits, int off) {
  extern __shared__ int32_t a_s[];
  const int c = blockIdx.y;
  const int r = blockIdx.x * TILE_R + threadIdx.x;
  const int a_len = min(max(a_len_arr[c], 0), n);
  for (int i = threadIdx.x; i < a_len; i += blockDim.x)
    a_s[i] = a_keys[(size_t)c * n + i];
  __syncthreads();
  if (r >= R) return;
  const int b_len = min(max(b_len_arr[r], 0), m);
  int32_t* o = out + (size_t)c * R + r;
  if (a_len == 0 || b_len == 0) {  // the score of an empty side is 0
    *o = 0;
    return;
  }
  const int S = e_bits + 2;
  const uint32_t dp1 = 1u << S;  // one dp unit
  const int32_t D_MATCH = (int32_t)(3u << e_bits);
  const int32_t D_MIS = (int32_t)((3u << e_bits) - dp1);
  const int32_t D_VERT = (int32_t)((2u << e_bits) - dp1);
  const int32_t D_HORIZ = (int32_t)((1u << e_bits) - dp1);
  const int32_t NO_PRIO = ~(int32_t)(3u << e_bits);
  const int32_t COL0 = (int32_t)((uint32_t)off << S);  // dp 0, E 0
  const size_t T = (size_t)gridDim.y * R;              // scratch row stride
  const size_t tid = (size_t)c * R + r;
  const int n_strips = (b_len + MT - 1) / MT;
  int32_t fin = 0;
  for (int s = 0; s < n_strips; ++s) {
    const int j0 = s * MT;  // column of the strip's left boundary
    int32_t bk[MT], P[MT], dv[MT];
#pragma unroll
    for (int jj = 0; jj < MT; ++jj) {
      const int j = j0 + jj + 1;
      bk[jj] = j <= m ? b_keys_t[(size_t)(j - 1) * R + r] : -2;
      P[jj] = (int32_t)((uint32_t)(row0_dp(j, a_len) + off) << S) + j;
      dv[jj] = j >= b_len ? 0 : D_VERT;  // free vertical: dp 0, prio 0
    }
    int32_t lp = (int32_t)((uint32_t)(row0_dp(j0, a_len) + off) << S) + j0;
    for (int i = 1; i <= a_len; ++i) {
      const int32_t a = a_s[i - 1];
      const size_t si = (size_t)(i - 1) * T + tid;
      const int32_t lc = s == 0 ? COL0 : scratch[si];
      int32_t dsrc = lp, left = lc;
#pragma unroll
      for (int jj = 0; jj < MT; ++jj) {
        const int32_t dg = dsrc + (a == bk[jj] ? D_MATCH : D_MIS);
        const int32_t up = P[jj] + dv[jj];
        const int32_t lf = left + D_HORIZ;
        const int32_t q = max(dg, max(up, lf)) & NO_PRIO;
        dsrc = P[jj];
        P[jj] = q;
        left = q;
      }
      lp = lc;
      if (s + 1 < n_strips) scratch[si] = P[MT - 1];
    }
    if (s + 1 == n_strips) {
      const int jf = b_len - 1 - j0;
#pragma unroll
      for (int jj = 0; jj < MT; ++jj)
        if (jj == jf) fin = P[jj];
    }
  }
  const int dp = (fin >> S) - off;
  const int e = fin & ((1 << e_bits) - 1);
  *o = dp + (e <= a_len ? e : 0);
}

template <int MT>
__global__ void __launch_bounds__(TILE_R)
nw_fwd_split_kernel(const int32_t* __restrict__ a_keys,
                    const int32_t* __restrict__ a_len_arr,
                    const int32_t* __restrict__ b_keys_t,
                    const int32_t* __restrict__ b_len_arr,
                    int32_t* __restrict__ out,
                    int32_t* __restrict__ scratch,
                    int n, int R, int m) {
  extern __shared__ int32_t a_s[];
  const int c = blockIdx.y;
  const int r = blockIdx.x * TILE_R + threadIdx.x;
  const int a_len = min(max(a_len_arr[c], 0), n);
  for (int i = threadIdx.x; i < a_len; i += blockDim.x)
    a_s[i] = a_keys[(size_t)c * n + i];
  __syncthreads();
  if (r >= R) return;
  const int b_len = min(max(b_len_arr[r], 0), m);
  int32_t* o = out + (size_t)c * R + r;
  if (a_len == 0 || b_len == 0) {
    *o = 0;
    return;
  }
  const size_t T = (size_t)gridDim.y * R;
  const size_t plane = T * (size_t)n;  // E plane follows the dp plane
  const size_t tid = (size_t)c * R + r;
  const int n_strips = (b_len + MT - 1) / MT;
  int32_t fin_dp = 0, fin_e = 0;
  for (int s = 0; s < n_strips; ++s) {
    const int j0 = s * MT;
    int32_t bk[MT], P[MT], PE[MT], vg[MT];
#pragma unroll
    for (int jj = 0; jj < MT; ++jj) {
      const int j = j0 + jj + 1;
      bk[jj] = j <= m ? b_keys_t[(size_t)(j - 1) * R + r] : -2;
      P[jj] = row0_dp(j, a_len);
      PE[jj] = j;  // a walk reaching row 0 exits at its column
      vg[jj] = j < b_len ? -1 : 0;
    }
    int32_t lp = row0_dp(j0, a_len), lpe = j0;
    for (int i = 1; i <= a_len; ++i) {
      const int32_t a = a_s[i - 1];
      const size_t si = (size_t)(i - 1) * T + tid;
      int32_t lc = 0, lce = 0;  // column 0: dp 0, exit column 0
      if (s > 0) {
        lc = scratch[si];
        lce = scratch[plane + si];
      }
      int32_t dsrc = lp, dsrc_e = lpe, left = lc, left_e = lce;
#pragma unroll
      for (int jj = 0; jj < MT; ++jj) {
        const int32_t up_raw = P[jj];
        const int32_t dg = dsrc + (a == bk[jj] ? 0 : -1);
        const int32_t q = max(dg, max(up_raw + vg[jj], left - 1));
        // the walk's move priority: diagonal, then up when the RAW up
        // predecessor is >= the left one, else left
        const int32_t e = q == dg ? dsrc_e : (up_raw >= left ? PE[jj] : left_e);
        dsrc = up_raw;
        dsrc_e = PE[jj];
        P[jj] = q;
        PE[jj] = e;
        left = q;
        left_e = e;
      }
      lp = lc;
      lpe = lce;
      if (s + 1 < n_strips) {
        scratch[si] = P[MT - 1];
        scratch[plane + si] = PE[MT - 1];
      }
    }
    if (s + 1 == n_strips) {
      const int jf = b_len - 1 - j0;
#pragma unroll
      for (int jj = 0; jj < MT; ++jj)
        if (jj == jf) {
          fin_dp = P[jj];
          fin_e = PE[jj];
        }
    }
  }
  *o = fin_dp + (fin_e <= a_len ? fin_e : 0);
}

int bit_length(int x) {
  int k = 0;
  while (x >> k) ++k;
  return k;
}

// Launch checks shared by both launchers; returns 0 or a cudaError_t.
int check_shape(int C, int n, int R, int m, const void* scratch) {
  if (C <= 0 || C > 65535 || n <= 0 || R <= 0 || m <= 0)
    return (int)cudaErrorInvalidValue;
  if ((size_t)n * sizeof(int32_t) > 227 * 1024)  // candidate row in smem
    return (int)cudaErrorInvalidValue;
  if (m > STRIP && scratch == nullptr) return (int)cudaErrorInvalidValue;
  return 0;
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

// a_keys (C, n), a_len (C,), b_keys_t (m, R) read keys transposed,
// b_len (R,), out (C, R), all int32 and contiguous; scratch holds
// C * R * n int32 (K1) or twice that (K2) and may be null when m <= 32.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int nw_fwd_packed(const void* a_keys, const void* a_len,
                             const void* b_keys_t, const void* b_len,
                             void* out, void* scratch, int C, int n, int R,
                             int m, void* stream) {
  int err = check_shape(C, n, R, m, scratch);
  if (err) return err;
  const int n_diag = n + m;
  const int e_bits = bit_length(n_diag + 1) > 2 ? bit_length(n_diag + 1) : 2;
  const int off = n_diag + 2;
  if (e_bits + 2 + bit_length(off + 1) >= 31)  // packed-word bit budget
    return (int)cudaErrorInvalidValue;
  const dim3 grid((R + TILE_R - 1) / TILE_R, C);
  const size_t smem = (size_t)n * sizeof(int32_t);
  cudaStream_t st = (cudaStream_t)stream;
#define GF_PACKED(MT)                                                        \
  do {                                                                       \
    if ((err = prepare(nw_fwd_packed_kernel<MT>, smem))) return err;         \
    nw_fwd_packed_kernel<MT><<<grid, TILE_R, smem, st>>>(                    \
        (const int32_t*)a_keys, (const int32_t*)a_len,                       \
        (const int32_t*)b_keys_t, (const int32_t*)b_len, (int32_t*)out,      \
        (int32_t*)scratch, n, R, m, e_bits, off);                            \
  } while (0)
  if (m <= 8)
    GF_PACKED(8);
  else if (m <= 16)
    GF_PACKED(16);
  else
    GF_PACKED(STRIP);
#undef GF_PACKED
  return (int)cudaGetLastError();
}

extern "C" int nw_fwd_split(const void* a_keys, const void* a_len,
                            const void* b_keys_t, const void* b_len,
                            void* out, void* scratch, int C, int n, int R,
                            int m, void* stream) {
  int err = check_shape(C, n, R, m, scratch);
  if (err) return err;
  const dim3 grid((R + TILE_R - 1) / TILE_R, C);
  const size_t smem = (size_t)n * sizeof(int32_t);
  cudaStream_t st = (cudaStream_t)stream;
#define GF_SPLIT(MT)                                                         \
  do {                                                                       \
    if ((err = prepare(nw_fwd_split_kernel<MT>, smem))) return err;          \
    nw_fwd_split_kernel<MT><<<grid, TILE_R, smem, st>>>(                     \
        (const int32_t*)a_keys, (const int32_t*)a_len,                       \
        (const int32_t*)b_keys_t, (const int32_t*)b_len, (int32_t*)out,      \
        (int32_t*)scratch, n, R, m);                                         \
  } while (0)
  if (m <= 8)
    GF_SPLIT(8);
  else if (m <= 16)
    GF_SPLIT(16);
  else
    GF_SPLIT(STRIP);
#undef GF_SPLIT
  return (int)cudaGetLastError();
}
