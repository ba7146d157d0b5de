// A host stand-in for the part of the CUDA runtime and device built-ins
// that src/repro_torch/csrc/online_replay.cu uses, so that the CPU tests
// compile that source with g++ and run its kernels on the host
// (tests/test_torch_replay_host.py). One block only: a kernel's
// __shared__ variables become statics shared by the block's threads.
// A cooperative launch runs the block's threads as fibers (ucontext) on
// the calling OS thread, in turn: a thread runs until it waits at a
// barrier, then the next one runs. __syncthreads is a barrier of the
// block, a warp shuffle goes through a per-warp buffer between two
// barriers of the warp. Every thread runs the same code as on the card;
// only the interleaving is fixed, and no OS thread ever waits on another.
// Products and sums are single IEEE operations (the test builds without
// contraction), as __dmul_rn / __dadd_rn are on the card.
#pragma once
#include <ucontext.h>

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
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

inline HostIndex threadIdx{0};
inline HostIndex blockIdx{0};
inline HostIndex gridDim{1};

namespace host_cuda {
// the block's threads as fibers: the scheduler resumes each in turn
struct Fiber {
  ucontext_t ctx;
  std::unique_ptr<char[]> stack;
  bool done = false;
};
inline std::vector<Fiber>* fibers = nullptr;
inline ucontext_t scheduler;
inline unsigned current = 0;
constexpr size_t kStack = 256 << 10;

// hand the OS thread back to the scheduler (no-op outside a launch)
inline void yield() {
  if (fibers) swapcontext(&(*fibers)[current].ctx, &scheduler);
}

// arrive, then wait (letting the other threads run) until `expected`
// threads have arrived in this generation
struct Barrier {
  unsigned expected;
  unsigned arrived = 0;
  unsigned long long generation = 0;
  explicit Barrier(unsigned n) : expected(n) {}
  void arrive_and_wait() {
    const unsigned long long g = generation;
    if (++arrived == expected) {
      arrived = 0;
      ++generation;
      return;
    }
    while (generation == g) yield();
  }
};
inline Barrier* block_barrier;
inline std::vector<std::unique_ptr<Barrier>> warp_barriers;
inline long long warp_lanes[64][32];

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
inline void __nanosleep(unsigned) { host_cuda::yield(); }
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
  const T o = *p;
  *p += v;
  return o;
}
template <class T>
T atomicExch(T* p, T v) {
  const T o = *p;
  *p = v;
  return o;
}
template <class T>
T atomicMax(T* p, T v) {
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
  static Arg arg;
  static void (*entry)(A);
  arg = *static_cast<Arg*>(params[0]);
  entry = kernel;
  host_cuda::Barrier bar(block.x);
  host_cuda::block_barrier = &bar;
  host_cuda::warp_barriers.clear();
  for (unsigned w = 0; w < block.x / 32; ++w)
    host_cuda::warp_barriers.emplace_back(new host_cuda::Barrier(32));
  std::vector<host_cuda::Fiber> fibers(block.x);
  for (auto& f : fibers) {
    f.stack.reset(new char[host_cuda::kStack]);
    getcontext(&f.ctx);
    f.ctx.uc_stack.ss_sp = f.stack.get();
    f.ctx.uc_stack.ss_size = host_cuda::kStack;
    f.ctx.uc_link = &host_cuda::scheduler;
    makecontext(&f.ctx, +[] {
      entry(arg);
      (*host_cuda::fibers)[host_cuda::current].done = true;
    }, 0);
  }
  host_cuda::fibers = &fibers;
  for (unsigned left = block.x; left;) {
    left = 0;
    for (unsigned t = 0; t < block.x; ++t) {
      if (fibers[t].done) continue;
      host_cuda::current = t;
      threadIdx.x = t;
      swapcontext(&host_cuda::scheduler, &fibers[t].ctx);
      left += !fibers[t].done;
    }
  }
  host_cuda::fibers = nullptr;
  threadIdx.x = 0;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "host error"; }
