// K3: the Mamba2 SSD intra-chunk step (state-space duality), for Hopper
// (sm_90a).
//
// Replaces src/repro/kernels/ssd_scan/kernel.py:35 _kernel, launched by
// ssd_intra_chunk (:66); the plain version beside it is
// src/repro_torch/kernels/ssd_scan/ref.py::ssd_intra_chunk_ref. Per
// (batch*head bh, chunk c) with Q = chunk length and t, u in the chunk:
//
//   cum      = cumsum(dt * A)                                   (Q,)
//   Y_intra  = ((C B^T) o M) (dt X),  M[t,u] = exp(cum_t - cum_u) if u <= t
//   S_chunk  = (B * dt * exp(cum_Q - cum))^T X                  (s, ph)
//   expcum   = exp(cum),  chunk_decay = exp(cum_Q)
//
//   X (BH, S, ph) and B, C (BH, S, s) f32 or bf16, read as f32; dt (BH, S)
//   and A (BH,) f32; every output f32 and contiguous. S = nc * Q.
//
// One block per (chunk, bh), 256 threads. The cumsum of the chunk's Q <=
// 256 values of dt * A is a Hillis-Steele scan in shared memory. Y_intra
// goes by 64-row tiles of t; for each, the 64-column tiles of u up to the
// diagonal (the tiles above it are all zero and are skipped): the block
// forms G = C_t . B_u in registers (thread (ty, tx) of a 16 x 16 grid owns
// rows ty + 16 i and columns tx + 16 j), weights it by M, stores it in
// shared memory and multiplies it into dt * X. For u > t, cum_t - cum_u >= 0
// and exp() overflows to inf where A is large (A reaches -16 in Mamba2's
// init), so M is a select, never a product with a 0/1 mask: inf * 0 is
// NaN. The chunk state is a second pass over the u tiles with B weighted
// by dt * exp(cum_Q - cum) on load.
//
// Bound on an H100 SXM at the serving shape (BH 256, S 512, ph 64, s 128,
// Q 256, X/B/C bf16): bytes, reads X 16,777,216, B and C 33,554,432 each,
// dt 524,288, A 1,024; writes Y_intra 33,554,432, S_chunk 16,777,216,
// expcum 524,288, chunk_decay 2,048: 135,269,376 B at 3.35 TB/s = 40.4 us
// a launch. FLOPs as the TPU kernel counts them (no causal skip) 15.0 G:
// 15 us at the bf16 tensor-core peak, ~224 us on the f32 CUDA cores that
// this first kernel uses (wgmma and TMA are for a later kernel).
//
// Limits (the wrapper checks them): Q <= 256, ph <= 64, s <= 128. Shared
// memory (dynamic): cum and dt (2 x 256), C and B tiles 64 x (s | 1), the
// weighted scores 64 x 65 and an X tile 64 x ph, all f32: 101,120 B at
// s = 128, ph = 64. The kernel allocates nothing, runs on the caller's
// stream and never synchronises; the C entry returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;  // a 16 x 16 grid of threads
constexpr int QMAX = 256;     // chunk length
constexpr int TT = 64;        // rows (t) per tile
constexpr int TU = 64;        // columns (u) per tile
constexpr int PH_MAX = 64;
constexpr int S_MAX = 128;
constexpr int TP = PH_MAX / 16;  // ph columns per thread
constexpr int TS = S_MAX / 16;   // state rows per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

inline int bs_stride(int s) { return s | 1; }  // odd: no bank conflicts

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_intra_chunk_kernel(const T* __restrict__ X, const float* __restrict__ dt,
                       const float* __restrict__ A, const T* __restrict__ Bm,
                       const T* __restrict__ Cm, float* __restrict__ Y,
                       float* __restrict__ Sc, float* __restrict__ expcum,
                       float* __restrict__ decay, int S, int Q, int ph,
                       int s) {
  extern __shared__ float smem[];
  const int st = s | 1;
  float* cum_s = smem;                // [QMAX]
  float* dt_s = cum_s + QMAX;         // [QMAX]
  float* c_s = dt_s + QMAX;           // [TT][st]
  float* b_s = c_s + TT * st;         // [TU][st]
  float* g_s = b_s + TU * st;         // [TT][TU + 1]
  float* x_s = g_s + TT * (TU + 1);   // [TU][ph]

  const int c = blockIdx.x, bh = blockIdx.y, nc = gridDim.x;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long row0 = (long long)bh * S + (long long)c * Q;  // (bh, c*Q)
  const float a = A[bh];

  // ---- cum = cumsum(dt * A) over the chunk (Hillis-Steele) ----
  const float dtv = tid < Q ? dt[row0 + tid] : 0.f;
  dt_s[tid] = dtv;
  cum_s[tid] = dtv * a;
  __syncthreads();
  for (int off = 1; off < Q; off <<= 1) {
    const float add = (tid >= off && tid < Q) ? cum_s[tid - off] : 0.f;
    __syncthreads();
    cum_s[tid] += add;
    __syncthreads();
  }
  if (tid < Q) expcum[row0 + tid] = expf(cum_s[tid]);
  const float cum_last = cum_s[Q - 1];
  if (tid == 0) decay[(long long)bh * nc + c] = expf(cum_last);

  // ---- Y_intra, by 64-row tiles of t ----
  for (int t0 = 0; t0 < Q; t0 += TT) {
    __syncthreads();
    for (int idx = tid; idx < TT * s; idx += THREADS) {
      const int r = idx / s, n = idx % s, t = t0 + r;
      c_s[r * st + n] = t < Q ? to_f32(Cm[(row0 + t) * s + n]) : 0.f;
    }
    float acc[4][TP];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int p = 0; p < TP; ++p) acc[i][p] = 0.f;

    for (int u0 = 0; u0 <= t0; u0 += TU) {  // tiles on or below the diagonal
      __syncthreads();
      for (int idx = tid; idx < TU * s; idx += THREADS) {
        const int r = idx / s, n = idx % s, u = u0 + r;
        b_s[r * st + n] = u < Q ? to_f32(Bm[(row0 + u) * s + n]) : 0.f;
      }
      for (int idx = tid; idx < TU * ph; idx += THREADS) {
        const int r = idx / ph, p = idx % ph, u = u0 + r;
        x_s[r * ph + p] =
            u < Q ? dt_s[u] * to_f32(X[(row0 + u) * ph + p]) : 0.f;
      }
      __syncthreads();

      float g[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < s; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = c_s[(ty + 16 * i) * st + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = b_s[(tx + 16 * j) * st + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = fmaf(cv[i], bv[j], g[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int u = u0 + tx + 16 * j;
          const bool keep = u <= t && t < Q;
          g_s[(ty + 16 * i) * (TU + 1) + tx + 16 * j] =
              keep ? g[i][j] * expf(cum_s[t] - cum_s[u]) : 0.f;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int uu = 0; uu < TU; ++uu) {
        float gv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) gv[i] = g_s[(ty + 16 * i) * (TU + 1) + uu];
#pragma unroll
        for (int p = 0; p < TP; ++p) {
          const int col = tx + 16 * p;
          const float xv = col < ph ? x_s[uu * ph + col] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][p] = fmaf(gv[i], xv, acc[i][p]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty + 16 * i;
      if (t >= Q) continue;
#pragma unroll
      for (int p = 0; p < TP; ++p) {
        const int col = tx + 16 * p;
        if (col < ph) Y[(row0 + t) * ph + col] = acc[i][p];
      }
    }
  }

  // ---- chunk state: (B * dt * exp(cum_Q - cum))^T X ----
  float sacc[TS][TP];
#pragma unroll
  for (int i = 0; i < TS; ++i)
#pragma unroll
    for (int p = 0; p < TP; ++p) sacc[i][p] = 0.f;
  for (int u0 = 0; u0 < Q; u0 += TU) {
    __syncthreads();
    for (int idx = tid; idx < TU * s; idx += THREADS) {
      const int r = idx / s, n = idx % s, u = u0 + r;
      b_s[r * st + n] =
          u < Q ? to_f32(Bm[(row0 + u) * s + n]) *
                      (dt_s[u] * expf(cum_last - cum_s[u]))
                : 0.f;
    }
    for (int idx = tid; idx < TU * ph; idx += THREADS) {
      const int r = idx / ph, p = idx % ph, u = u0 + r;
      x_s[r * ph + p] = u < Q ? to_f32(X[(row0 + u) * ph + p]) : 0.f;
    }
    __syncthreads();
    for (int uu = 0; uu < TU; ++uu) {
      float bv[TS], xv[TP];
#pragma unroll
      for (int i = 0; i < TS; ++i) {
        const int n = ty + 16 * i;
        bv[i] = n < s ? b_s[uu * st + n] : 0.f;
      }
#pragma unroll
      for (int p = 0; p < TP; ++p) {
        const int col = tx + 16 * p;
        xv[p] = col < ph ? x_s[uu * ph + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < TS; ++i)
#pragma unroll
        for (int p = 0; p < TP; ++p) sacc[i][p] = fmaf(bv[i], xv[p], sacc[i][p]);
    }
  }
  float* sc = Sc + ((long long)bh * nc + c) * s * ph;
#pragma unroll
  for (int i = 0; i < TS; ++i) {
    const int n = ty + 16 * i;
    if (n >= s) continue;
#pragma unroll
    for (int p = 0; p < TP; ++p) {
      const int col = tx + 16 * p;
      if (col < ph) sc[n * ph + col] = sacc[i][p];
    }
  }
}

template <typename T>
cudaError_t launch(const void* X, const float* dt, const float* A,
                   const void* Bm, const void* Cm, float* Y, float* Sc,
                   float* expcum, float* decay, int BH, int S, int Q, int ph,
                   int s, cudaStream_t stream) {
  const int st = bs_stride(s);
  const int bytes =
      (2 * QMAX + 2 * TT * st + TT * (TU + 1) + TU * ph) * (int)sizeof(float);
  auto kern = ssd_intra_chunk_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(S / Q, BH);
  kern<<<grid, THREADS, bytes, stream>>>((const T*)X, dt, A, (const T*)Bm,
                                         (const T*)Cm, Y, Sc, expcum, decay,
                                         S, Q, ph, s);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (X, B and C alike). Every tensor is
// contiguous; S % Q == 0, Q <= 256, ph <= 64, s <= 128.
int ssd_intra_chunk_launch(const void* X, const void* dt, const void* A,
                           const void* Bm, const void* Cm, void* Y, void* Sc,
                           void* expcum, void* decay, int dtype, int BH,
                           int S, int Q, int ph, int s, void* stream) {
  if (Q < 1 || Q > QMAX || S % Q != 0 || ph < 1 || ph > PH_MAX || s < 1 ||
      s > S_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(X, (const float*)dt, (const float*)A, Bm, Cm,
                        (float*)Y, (float*)Sc, (float*)expcum,
                        (float*)decay, BH, S, Q, ph, s, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(X, (const float*)dt, (const float*)A, Bm, Cm,
                                (float*)Y, (float*)Sc, (float*)expcum,
                                (float*)decay, BH, S, Q, ph, s, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

const char* ssd_intra_chunk_launch_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
