// Online's in-slot replay (Alg. 2, the scan engine's sequential step) for
// one H100, plain CUDA C++ behind a C entry point (loaded with ctypes).
//
// Replaces no TPU kernel: it is the body of the JAX package's
// OnlinePolicy.scan_step `slow` branch (src/repro/core/policies.py:504), a
// lax.scan over the users of a slot in index order, which XLA compiles
// for the TPU. Eager PyTorch has no loop that stays on the device, so the
// port walks the users here: without a kernel the walk would be one launch
// per user per slot, or a round trip to the host every slot.
//
// Per config row, with j the users scheduled so far this slot:
//   do_i = w_i && b_i + H * gap_vec[j] <= r_i + H * g_i
//   gs  += w_i ? (do_i ? gap_vec[j] : g_i) : 0          (j read before do_i)
//   j   += do_i
// where b_i = V P_sched t_d - Q, r_i = V P_idle t_d, g_i = idle_gap_i + eps.
// With H == 0 the gap terms add exactly 0, so the same walk gives the
// elementwise decisions of the reference's `fast` branch: one launch a
// slot covers both branches and H is read here, never by the host.
//
// Every product and sum is __dmul_rn / __dadd_rn: nvcc contracts a*b + c
// into an fma by default, which skips the product's rounding that the
// reference forces with its traced zero (policies.py:257-268, 479-481) and
// the host engines round by construction. With them the kernel equals its
// plain version (kernels/online_replay/ref.py) bit for bit.
//
// Bound: a user who is not waiting adds nothing and leaves j as it is,
// so the dependent chain runs over the waiting users only: the decision
// of a waiting user picks the gap the next waiting user compares with,
// and the gap sum adds one term a waiting user in order. No layout of the
// data beats (waiting users of the fullest row) times the latency of one
// dependent f64 add; its bytes (34 a user) take microseconds. One thread
// walks a row, one block a row (config rows run on separate SMs); the
// block stages each tile of users and of reachable gaps in shared memory
// and computes there everything that does not depend on the walk, so the
// walking thread's chain is an add, a compare and the gap window's
// selects a waiting user (the window's refill, a shared-memory load,
// still depends on j; PERF.md has the kernel's time against its bound).
// dadd_chain_launch times a chain of dependent adds on this card: the
// yardstick for that bound.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 1024;     // users a tile
constexpr int THREADS = 256;   // threads that stage a tile
constexpr int AHEAD = 4;       // gaps the walking thread holds in registers

// One block a config row. For each tile of TILE users the block stages
// the users' operands in shared memory (base and r + H * g_i, which no
// decision changes, side by side; the idle gap; the waiting flag) and the
// window of gaps the walk can reach (gap_vec[j0 ..] and H times each, side
// by side); then thread 0 walks the tile; then the block writes the tile's
// decisions out. The walking thread loads the next user's operands one
// step ahead and holds the next AHEAD gaps in registers, shifted by
// selects when the walk advances j; a user who is not waiting (most
// users, at fleet scale, in most slots) costs one branch. 43 KB of static
// shared memory.
__global__ void __launch_bounds__(THREADS)
online_replay_kernel(const uint8_t* __restrict__ waiting,
                     const double* __restrict__ base,
                     const double* __restrict__ rhs,
                     const double* __restrict__ gap_idle,
                     const double* __restrict__ gap_vec,
                     const double* __restrict__ H,
                     uint8_t* __restrict__ start,
                     double* __restrict__ gap_sum, long long n) {
  // one spare user entry: the walk loads user k + 1 while it decides k
  __shared__ double2 s_bc[TILE + 1];
  __shared__ double s_gi[TILE + 1];
  __shared__ double2 s_g[TILE + AHEAD];      // (gap, H * gap)
  __shared__ uint8_t s_w[TILE + 1], s_d[TILE];
  __shared__ long long s_j;
  __shared__ double s_gs;
  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const uint8_t* w = waiting + row * n;
  const double* b = base + row * n;
  const double* r = rhs + row * n;
  const double* gi = gap_idle + row * n;
  const double* gv = gap_vec + row * (n + 1);  // lags in_flight .. + n
  uint8_t* s = start + row * n;
  const double h = H[row];
  if (tid == 0) {
    s_j = 0;
    s_gs = 0.0;
  }
  __syncthreads();
  for (long long t0 = 0; t0 < n; t0 += TILE) {
    const int m = (int)(n - t0 < TILE ? n - t0 : TILE);
    const long long j0 = s_j;
    for (int k = tid; k < m; k += THREADS) {
      const double g = gi[t0 + k];
      s_w[k] = w[t0 + k];
      s_bc[k] = make_double2(b[t0 + k],
                             __dadd_rn(r[t0 + k], __dmul_rn(h, g)));
      s_gi[k] = g;
    }
    // this tile moves j by at most m: the walk reads entries 0 .. m + 3
    for (int k = tid; k < m + AHEAD; k += THREADS) {
      const double g = gv[j0 + k < n ? j0 + k : n];
      s_g[k] = make_double2(g, __dmul_rn(h, g));
    }
    __syncthreads();
    if (tid == 0) {
      int jl = 0;
      double gs = s_gs;
      double2 g0 = s_g[0], g1 = s_g[1], g2 = s_g[2], g3 = s_g[3];
      bool wn = s_w[0];
      double2 bcn = s_bc[0];
      double gin = s_gi[0];
#pragma unroll 4
      for (int k = 0; k < m; ++k) {
        const bool wk = wn;
        const double2 bc = bcn;
        const double gk = gin;
        wn = s_w[k + 1];
        bcn = s_bc[k + 1];
        gin = s_gi[k + 1];
        bool d = false;
        if (wk) {   // a user who is not waiting adds 0 and keeps j
          d = __dadd_rn(bc.x, g0.y) <= bc.y;
          gs = __dadd_rn(gs, d ? g0.x : gk);
          jl += d;
          g0 = d ? g1 : g0;
          g1 = d ? g2 : g1;
          g2 = d ? g3 : g2;
          g3 = s_g[jl + 3];
        }
        s_d[k] = (uint8_t)d;
      }
      s_j = j0 + jl;
      s_gs = gs;
    }
    __syncthreads();
    for (int k = tid; k < m; k += THREADS) s[t0 + k] = s_d[k];
    __syncthreads();
  }
  if (tid == 0) gap_sum[row] = s_gs;
}

__global__ void __launch_bounds__(1)
dadd_chain_kernel(double* out, long long m, double x) {
  const long long c0 = clock64();
  double acc = out[0];
#pragma unroll 8
  for (long long i = 0; i < m; ++i) acc = __dadd_rn(acc, x);
  const long long c1 = clock64();
  out[0] = acc;
  out[1] = (double)(c1 - c0);
}

}  // namespace

extern "C" {

// waiting (B, n) uint8; base, rhs, gap_idle (B, n) f64; gap_vec (B, n + 1)
// f64; H (B,) f64; outputs start (B, n) uint8 and gap_sum (B,) f64. All
// contiguous on one device. One block a row.
int online_replay_launch(const void* waiting, const void* base,
                         const void* rhs, const void* gap_idle,
                         const void* gap_vec, const void* H, void* start,
                         void* gap_sum, long long B, long long n,
                         void* stream) {
  if (B < 1 || B > 2147483647LL || n < 0) return (int)cudaErrorInvalidValue;
  online_replay_kernel<<<(unsigned)B, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)waiting, (const double*)base, (const double*)rhs,
      (const double*)gap_idle, (const double*)gap_vec, (const double*)H,
      (uint8_t*)start, (double*)gap_sum, n);
  return (int)cudaGetLastError();
}

// out (2,) f64: out[0] seeds the chain and receives its end, out[1] the
// clock64 cycles the m dependent adds of x took in one thread.
int dadd_chain_launch(void* out, long long m, double x, void* stream) {
  if (m < 0) return (int)cudaErrorInvalidValue;
  dadd_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((double*)out, m, x);
  return (int)cudaGetLastError();
}

const char* online_replay_launch_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

const char* dadd_chain_launch_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
