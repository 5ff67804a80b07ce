// Host stand-in for <cuda_runtime.h>: lets a C++20 host compiler build the
// .cu sources of this directory (after ops/cuda_build.py has rewritten their
// <<<...>>> launches and `extern __shared__` arrays) so that a kernel's
// control flow, indexing, barriers and shuffles can be run on a CPU.  Blocks
// run one after another in launch order (so a block that waits for an
// earlier one finds it finished); the threads of a block are OS threads,
// __syncthreads() is a std::barrier over the block, static __shared__
// arrays are statics (one block runs at a time), and the warp intrinsics
// are an exchange through a slot per lane between two barriers over the
// warp, so a kernel must call them as CUDA requires: every thread of the
// block, or every lane of the warp, the same number of times.  Nothing here
// says anything about speed or about what nvcc accepts.
#pragma once
#define GF_HOST_SHIM 1
#include <algorithm>
#include <atomic>
#include <barrier>
#include <climits>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __shared__ static

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <typename K>
cudaError_t cudaFuncSetAttribute(K, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return cudaSuccess;
}

static dim3 blockIdx, gridDim, blockDim;
struct HostThreadIdx { unsigned x; };
static thread_local HostThreadIdx threadIdx;
static int32_t* host_shared;  // the running block's dynamic shared memory
static std::barrier<>* host_block_barrier;
static std::vector<std::unique_ptr<std::barrier<>>> host_warp_barriers;
static int64_t host_shuffle_slots[32][32];

using std::max;
using std::min;

inline void __syncthreads() { host_block_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  host_warp_barriers[threadIdx.x >> 5]->arrive_and_wait();
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }

// v of lane `src` of this thread's warp (any type of at most 8 bytes)
template <typename T>
T host_exchange(T v, int src) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  int64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  host_shuffle_slots[w][l] = bits;
  host_warp_barriers[w]->arrive_and_wait();
  T r;
  std::memcpy(&r, &host_shuffle_slots[w][src], sizeof(T));
  host_warp_barriers[w]->arrive_and_wait();
  return r;
}

template <typename T>
T __shfl_up_sync(unsigned, T v, int delta, int width = 32) {
  const int l = threadIdx.x & 31;
  return host_exchange(v, l % width >= delta ? l - delta : l);
}

template <typename T>
T __shfl_down_sync(unsigned, T v, int delta, int width = 32) {
  const int l = threadIdx.x & 31;
  return host_exchange(v, l % width + delta < width ? l + delta : l);
}

template <typename T>
T __shfl_xor_sync(unsigned, T v, int mask, int width = 32) {
  const int l = threadIdx.x & 31;
  const int src = l ^ mask;
  return host_exchange(v, src / width == l / width ? src : l);
}

inline int __any_sync(unsigned, int p) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  host_shuffle_slots[w][l] = p != 0;
  host_warp_barriers[w]->arrive_and_wait();
  int any = 0;
  for (int k = 0; k < std::min(32, (int)blockDim.x - 32 * w); ++k)
    any |= host_shuffle_slots[w][k] != 0;
  host_warp_barriers[w]->arrive_and_wait();
  return any;
}

template <typename T>
T atomicAdd(T* p, T v) { return std::atomic_ref<T>(*p).fetch_add(v); }

// the kernels' release store and acquire load (inline PTX on the card)
inline void store_release(int32_t* p, int32_t v) {
  std::atomic_ref<int32_t>(*p).store(v, std::memory_order_release);
}
inline int32_t load_acquire(const int32_t* p) {
  return std::atomic_ref<int32_t>(*const_cast<int32_t*>(p))
      .load(std::memory_order_acquire);
}

template <typename T>
T atomicMax(T* p, T v) {
  std::atomic_ref<T> a(*p);
  T old = a.load();
  while (old < v && !a.compare_exchange_weak(old, v)) {
  }
  return old;
}

template <typename T>
T __ldcg(const T* p) { return *p; }

inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, unsigned shift) {
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> (shift & 31));
}

inline int32_t __viaddmax_s32(int32_t a, int32_t b, int32_t c) {
  return std::max(a + b, c);
}

inline int32_t __viaddmax_s32_relu(int32_t a, int32_t b, int32_t c) {
  return std::max(std::max(a + b, c), 0);
}

// kernel<<<grid, threads, shared_bytes, stream>>>(args) becomes
// host_launch(grid, threads, shared_bytes, [=]() { kernel(args); }).
template <typename F>
void host_launch(dim3 grid, int threads, size_t shared_bytes, F kernel) {
  gridDim = grid;
  blockDim = dim3(threads);
  std::vector<int32_t> shared(shared_bytes / 4 + 1);
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        blockIdx = dim3(x, y, z);
        std::fill(shared.begin(), shared.end(), 0x7badbeef);
        host_shared = shared.data();
        std::barrier<> block_barrier(threads);
        host_block_barrier = &block_barrier;
        host_warp_barriers.clear();
        for (int w = 0; w * 32 < threads; ++w)
          host_warp_barriers.emplace_back(
              new std::barrier<>(std::min(32, threads - 32 * w)));
        std::vector<std::thread> pool;
        for (int t = 0; t < threads; ++t)
          pool.emplace_back([=] {
            threadIdx.x = t;
            kernel();
          });
        for (auto& th : pool) th.join();
      }
}
