// A host stand-in for the part of the CUDA runtime and device built-ins
// that src/repro_torch/csrc/online_replay.cu uses, so that the CPU tests
// compile that source with g++ and run its kernels on the host
// (tests/test_torch_replay_host.py). One block only: a kernel's
// __shared__ variables become statics shared by the block's threads.
// A cooperative launch runs the block's threads as OS threads;
// __syncthreads is a barrier of the block, a warp shuffle goes through a
// per-warp buffer between two barriers of the warp; atomics take a lock.
// Products and sums are single IEEE operations (the test builds without
// contraction), as __dmul_rn / __dadd_rn are on the card.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <type_traits>
#include <vector>

using std::isfinite;
using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __shared__ static
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(x) __attribute__((aligned(x)))

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9,
  cudaDevAttrMultiProcessorCount = 16,
};

struct dim3 {
  unsigned x;
  dim3(unsigned x_ = 1, unsigned = 1, unsigned = 1) : x(x_) {}
};
struct alignas(16) int4 {
  int x, y, z, w;
};
struct HostIndex {
  unsigned x;
};

inline thread_local HostIndex threadIdx{0};
inline HostIndex blockIdx{0};
inline HostIndex gridDim{1};

namespace host_cuda {
inline std::barrier<>* block_barrier;
inline std::vector<std::unique_ptr<std::barrier<>>> warp_barriers;
inline long long warp_lanes[64][32];
inline std::mutex atomic_lock;

template <class T>
T shuffle_from(T v, int src) {
  static_assert(sizeof(T) <= sizeof(long long));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  long long bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  warp_lanes[warp][lane] = bits;
  warp_barriers[warp]->arrive_and_wait();
  T out;
  bits = warp_lanes[warp][src];
  std::memcpy(&out, &bits, sizeof(T));
  warp_barriers[warp]->arrive_and_wait();
  return out;
}
}  // namespace host_cuda

inline void __syncthreads() { host_cuda::block_barrier->arrive_and_wait(); }
inline void __syncwarp() {
  host_cuda::warp_barriers[threadIdx.x >> 5]->arrive_and_wait();
}
inline void __threadfence() {}
inline void __nanosleep(unsigned) {}
inline void __trap() { std::abort(); }
inline long long clock64() { return 0; }

template <class T>
T __shfl_xor_sync(unsigned, T v, int o) {
  return host_cuda::shuffle_from(v, (int)(threadIdx.x & 31) ^ o);
}
template <class T>
T __shfl_up_sync(unsigned, T v, int o) {
  const int lane = threadIdx.x & 31;
  return host_cuda::shuffle_from(v, lane >= o ? lane - o : lane);
}
template <class T>
T __ldg(const T* p) { return *p; }
template <class T>
T __ldcg(const T* p) { return *p; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dmul_rn(double a, double b) { return a * b; }

template <class T>
T atomicAdd(T* p, T v) {
  std::lock_guard<std::mutex> g(host_cuda::atomic_lock);
  const T o = *p;
  *p += v;
  return o;
}
template <class T>
T atomicExch(T* p, T v) {
  std::lock_guard<std::mutex> g(host_cuda::atomic_lock);
  const T o = *p;
  *p = v;
  return o;
}
template <class T>
T atomicMax(T* p, T v) {
  std::lock_guard<std::mutex> g(host_cuda::atomic_lock);
  const T o = *p;
  if (v > o) *p = v;
  return o;
}

inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = 1;   // one SM: one block
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* v, F, int,
                                                          size_t) {
  *v = 1;
  return cudaSuccess;
}
template <class A>
cudaError_t cudaLaunchCooperativeKernel(void (*kernel)(A), dim3 grid,
                                        dim3 block, void** params, size_t,
                                        cudaStream_t) {
  if (grid.x != 1 || block.x % 32 || block.x / 32 > 64)
    return cudaErrorInvalidConfiguration;
  using Arg = std::remove_const_t<A>;
  const Arg arg = *static_cast<Arg*>(params[0]);
  std::barrier<> bar(block.x);
  host_cuda::block_barrier = &bar;
  host_cuda::warp_barriers.clear();
  for (unsigned w = 0; w < block.x / 32; ++w)
    host_cuda::warp_barriers.emplace_back(new std::barrier<>(32));
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < block.x; ++t)
    threads.emplace_back([=] {
      threadIdx.x = t;
      kernel(arg);
    });
  for (auto& t : threads) t.join();
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "host error"; }
