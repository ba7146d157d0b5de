// K4: blocked online-softmax attention with GQA and causal block skip, for
// Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention/kernel.py:38 _kernel, launched
// by flash_attention_kernel (:87); the plain version beside it is
// src/repro_torch/kernels/flash_attention/ref.py::attention_ref.
//
//   q (B, H, Sq, d), k/v (B, KV, Sk, d), f32 or bf16, any strides with the
//   last dimension contiguous; o like q. Query head h reads KV head
//   h * KV / H (the TPU kernel's index map), never a repeated copy.
//   Scores, the running max m, the denominator l and the accumulator are
//   f32; the output is written in q's dtype.
//
// One block per (64-row query tile, head, batch), 256 threads. The block
// loads its q tile once, then walks 64-key tiles of k and v up to the
// causal limit (the tiles the TPU kernel skips with pl.when are never
// loaded here), and keeps m, l and the accumulator in registers across
// tiles. Thread (ty, tx) of a 16 x 16 grid owns query rows ty + 16 i
// (i < 4), key columns tx + 16 j (j < 4) of a score tile, and output
// columns tx + 16 c (c < d / 16); a row's max and sum are reduced over the
// 16 threads of a half-warp with shuffles. Masked scores are set to -inf
// by a select (never by multiplying), and the ragged tail is masked in the
// kernel: rows >= Sq are not written, keys >= Sk score -inf. Causal use
// requires Sq == Sk (the wrapper raises otherwise): row i attends keys
// j <= i.
//
// Bound on an H100 SXM at the serving shape (B 8, H 16, KV 8, S 512, d
// 128, bf16): bytes, q and o 16,777,216 each, k and v 8,388,608 each,
// 50,331,648 B at 3.35 TB/s = 15.0 us a launch; the causal FLOPs (8.6 G)
// take 8.7 us at the bf16 tensor-core peak. This first kernel runs its
// products as f32 FMAs on the CUDA cores (67 TFLOP/s peak, so no less
// than ~128 us); wgmma and TMA are for a later kernel.
//
// Tiles live in dynamic shared memory as f32 (115,712 B at d = 128, set
// with cudaFuncSetAttribute): q tile 64 x (d+1), k tile transposed
// d x 65, v tile 64 x d and the probabilities 64 x 65 (the +1 columns
// keep a warp's reads on distinct banks). The kernel allocates nothing,
// runs on the caller's stream and never synchronises; the C entry
// returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // keys per tile
constexpr int THREADS = 256;  // a 16 x 16 grid of threads
constexpr int TM = BM / 16;   // rows per thread
constexpr int TN = BN / 16;   // key columns per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr int smem_floats() {
  return BM * (D + 1) + D * (BN + 1) + BN * D + BM * (BN + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int KV, int Sq, int Sk, int q_sb, int q_sh, int q_ss,
                       int k_sb, int k_sh, int k_ss, int v_sb, int v_sh,
                       int v_ss, int o_sb, int o_sh, int o_ss, float scale,
                       int causal) {
  constexpr int TD = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                    // [BM][D + 1]
  float* kt_s = q_s + BM * (D + 1);     // [D][BN + 1], k tile transposed
  float* v_s = kt_s + D * (BN + 1);     // [BN][D]
  float* p_s = v_s + BN * D;            // [BM][BN + 1]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM;
  const int kvh = (int)((long long)h * KV / H);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  const T* qb = q + (long long)b * q_sb + (long long)h * q_sh;
  const T* kb = k + (long long)b * k_sb + (long long)kvh * k_sh;
  const T* vb = v + (long long)b * v_sb + (long long)kvh * v_sh;
  T* ob = o + (long long)b * o_sb + (long long)h * o_sh;

  for (int idx = tid; idx < BM * D; idx += THREADS) {
    const int r = idx / D, c = idx % D, row = q0 + r;
    q_s[r * (D + 1) + c] =
        row < Sq ? to_f32(qb[(long long)row * q_ss + c]) : 0.f;
  }

  float m[TM], l[TM], acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < TD; ++c) acc[i][c] = 0.f;
  }

  const int n_end = causal ? min(Sk, q0 + BM) : Sk;
  for (int k0 = 0; k0 < n_end; k0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BN * D; idx += THREADS) {
      const int n = idx / D, c = idx % D, key = k0 + n;
      const bool ok = key < Sk;
      kt_s[c * (BN + 1) + n] = ok ? to_f32(kb[(long long)key * k_ss + c]) : 0.f;
      v_s[n * D + c] = ok ? to_f32(vb[(long long)key * v_ss + c]) : 0.f;
    }
    __syncthreads();

    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; ++kk) {
      float a[TM], bk[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = q_s[(ty + 16 * i) * (D + 1) + kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) bk[j] = kt_s[kk * (BN + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool keep = col < Sk && (!causal || col <= row);
        s[i][j] = keep ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // a row with nothing unmasked yet keeps exp() arguments finite
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = expf(s[i][j] - m_use);
        p_s[(ty + 16 * i) * (BN + 1) + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < TD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < BN; ++n) {
      float pv[TM], vv[TD];
#pragma unroll
      for (int i = 0; i < TM; ++i) pv[i] = p_s[(ty + 16 * i) * (BN + 1) + n];
#pragma unroll
      for (int c = 0; c < TD; ++c) vv[c] = v_s[n * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < TD; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < TD; ++c)
      store(ob + (long long)row * o_ss + tx + 16 * c, acc[i][c] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KV, int Sq, int Sk, const int* st,
                   float scale, int causal, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * (int)sizeof(float);
  auto kern = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BM - 1) / BM, H, B);
  kern<<<grid, THREADS, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, KV, Sq, Sk, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int KV, int Sq, int Sk, int D,
                       const int* st, float scale, int causal,
                       cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, KV, Sq, Sk, st, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, H, KV, Sq, Sk, st, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, KV, Sq, Sk, st, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, KV, Sq, Sk, st, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike). strides: the
// element strides of (batch, head, position) for q, k, v, o in that order.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int B, int H, int KV, int Sq,
                           int Sk, int D, int q_sb, int q_sh, int q_ss,
                           int k_sb, int k_sh, int k_ss, int v_sb, int v_sh,
                           int v_ss, int o_sb, int o_sh, int o_ss,
                           float scale, int causal, void* stream) {
  const int st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                      v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(q, k, v, o, B, H, KV, Sq, Sk, D, st, scale, causal, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(q, k, v, o, B, H, KV, Sq, Sk, D, st, scale, causal, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

const char* flash_attention_launch_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
