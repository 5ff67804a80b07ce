// Host stand-in for <cuda_runtime.h>: lets a C++20 host compiler build the
// .cu sources of this directory (after ops/cuda_build.py has rewritten their
// <<<...>>> launches and `extern __shared__` arrays) so that a kernel's
// control flow, indexing, barriers and shuffles can be run on a CPU.  Blocks
// run one after another; the threads of a block are OS threads,
// __syncthreads() is a std::barrier over the block and __shfl_up_sync() an
// exchange through a slot per lane between two barriers over the warp, so a
// kernel must call them as CUDA requires: every thread of the block, or every
// lane of the warp, the same number of times.  Nothing here says anything
// about speed or about what nvcc accepts.
#pragma once
#include <algorithm>
#include <barrier>
#include <climits>
#include <cstdint>
#include <cstdlib>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)

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

static dim3 blockIdx, gridDim, blockDim;
struct HostThreadIdx { unsigned x; };
static thread_local HostThreadIdx threadIdx;
static int32_t* host_shared;  // the running block's dynamic shared memory
static std::barrier<>* host_block_barrier;
static std::vector<std::unique_ptr<std::barrier<>>> host_warp_barriers;
static int32_t host_shuffle_slots[32][32];

using std::max;
using std::min;

inline void __syncthreads() { host_block_barrier->arrive_and_wait(); }

inline int32_t __shfl_up_sync(unsigned, int32_t v, int delta) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  host_shuffle_slots[w][l] = v;
  host_warp_barriers[w]->arrive_and_wait();
  const int32_t r = l >= delta ? host_shuffle_slots[w][l - delta] : v;
  host_warp_barriers[w]->arrive_and_wait();
  return r;
}

inline int32_t __viaddmax_s32(int32_t a, int32_t b, int32_t c) {
  return std::max(a + b, c);
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
