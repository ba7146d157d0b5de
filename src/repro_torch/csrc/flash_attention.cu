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
//   f32; the output is written in q's dtype. Causal use requires Sq == Sk
//   (the wrapper raises otherwise): row i attends keys j <= i. Masked
//   scores are set to -inf by a select (never by multiplying); rows >= Sq
//   are not written, keys >= Sk score -inf.
//
// The dtype picks the kernel; neither is a fallback of the other.
//
// bf16: flash_attention_bf16, tensor cores fed by TMA. One block per
// (128-row query tile, head, batch), the query tiles far down the causal
// diagonal (the ones that walk the most keys) first: two consumer
// warpgroups of 64 rows each and one producer warp. The producer loads
// the q tile once and the 64-key k and v tiles into a two-stage ring of
// shared memory (full and empty mbarriers per stage); tiles above the
// causal diagonal are never loaded. Each consumer warpgroup forms
// S = q k^T with wgmma m64n64k16 (both operands K-major in shared
// memory), runs the online softmax on the f32 accumulator fragments (a
// row's max and sum over the 4 threads that share it, exp2 with log2 e
// folded into the scale), rounds P to bf16 in registers and feeds it as
// the register A operand of O += P v, wgmma m64n{d}k16 with v read
// MN-major, so v is never transposed. O stays f32 in registers. The
// tensor maps are built on the caller's strides (TMA needs 16-byte
// aligned bases and strides; the wrapper checks), rows and keys past the
// end read as 0, and the swizzle follows d: 2d bytes up to 128.
// Shared memory at d = 128: q 32 KB + 2 stages x (k 16 KB + v 16 KB).
// Head dim 80 (zamba2's shared blocks, 2560 / 32) is no multiple of the
// 64-column chunk the 128-byte swizzle reads: it runs the d = 128 block
// on maps whose extent is the real 80 columns, so TMA zero-fills columns
// 80-127 of every q, k and v tile; the zero columns add nothing to a
// score and give output columns 80-127 that are not stored. This costs
// 60 % more MMA work than d = 80 needs, on a shape whose bound is its
// bytes; running at 80 itself would take a second, 32-byte-swizzled
// chunk and PV split into N = 64 and N = 16 wgmmas.
//
// f32: flash_attention_kernel, the first form of this kernel, on the
// CUDA cores. Thread (ty, tx) of a 16 x 16 grid owns query rows
// ty + 16 i (i < 4), key columns tx + 16 j (j < 4) of a score tile, and
// output columns tx + 16 c (c < d / 16, 5 at d = 80); a row's max and sum
// are reduced over the 16 threads of a half-warp with shuffles. Tiles live
// in dynamic shared memory as f32 (115,712 B at d = 128, 78,656 B at d =
// 80; the launch opts into it at every d): q tile 64 x (d+1), k tile
// transposed d x 65, v tile 64 x d and the probabilities 64 x 65 (the +1
// columns keep a warp's reads on distinct banks).
//
// Bound on an H100 SXM at the serving shape (B 8, H 16, KV 8, S 512, d
// 128, bf16): bytes, q and o 16,777,216 each, k and v 8,388,608 each,
// 50,331,648 B at 3.35 TB/s = 15.0 us a launch; the causal FLOPs (8.6 G)
// take 8.7 us at the bf16 tensor-core peak. The f32 form cannot go below
// ~128 us (67 TFLOP/s on the CUDA cores).
//
// Neither kernel allocates, both run on the caller's stream and never
// synchronise; the C entry returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // keys per tile
constexpr int THREADS = 256;  // a 16 x 16 grid of threads
constexpr int TM = BM / 16;   // rows per thread
constexpr int TN = BN / 16;   // key columns per thread

template <int D>
constexpr int smem_floats() {
  return BM * (D + 1) + D * (BN + 1) + BN * D + BM * (BN + 1);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int H, int KV, int Sq, int Sk, int q_sb, int q_sh, int q_ss,
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

  const float* qb = q + (long long)b * q_sb + (long long)h * q_sh;
  const float* kb = k + (long long)b * k_sb + (long long)kvh * k_sh;
  const float* vb = v + (long long)b * v_sb + (long long)kvh * v_sh;
  float* ob = o + (long long)b * o_sb + (long long)h * o_sh;

  for (int idx = tid; idx < BM * D; idx += THREADS) {
    const int r = idx / D, c = idx % D, row = q0 + r;
    q_s[r * (D + 1) + c] =
        row < Sq ? qb[(long long)row * q_ss + c] : 0.f;
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
      kt_s[c * (BN + 1) + n] = ok ? kb[(long long)key * k_ss + c] : 0.f;
      v_s[n * D + c] = ok ? vb[(long long)key * v_ss + c] : 0.f;
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
      ob[(long long)row * o_ss + tx + 16 * c] = acc[i][c] * inv;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KV, int Sq, int Sk, const int* st,
                   float scale, int causal, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * (int)sizeof(float);
  auto kern = flash_attention_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BM - 1) / BM, H, B);
  kern<<<grid, THREADS, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, H, KV, Sq,
      Sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], scale, causal);
  return cudaGetLastError();
}

cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int KV, int Sq, int Sk, int D,
                       const int* st, float scale, int causal,
                       cudaStream_t stream) {
  switch (D) {
    case 16: return launch<16>(q, k, v, o, B, H, KV, Sq, Sk, st, scale, causal, stream);
    case 32: return launch<32>(q, k, v, o, B, H, KV, Sq, Sk, st, scale, causal, stream);
    case 64: return launch<64>(q, k, v, o, B, H, KV, Sq, Sk, st, scale, causal, stream);
    case 80: return launch<80>(q, k, v, o, B, H, KV, Sq, Sk, st, scale, causal, stream);
    case 128: return launch<128>(q, k, v, o, B, H, KV, Sq, Sk, st, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}


// ------------------------------------------------------------------ bf16
namespace bf16k {

constexpr int BQ = 128;          // query rows a block: two warpgroups
constexpr int BK = 64;           // keys a tile
constexpr int STAGES = 2;        // k/v ring depth
constexpr int THREADS = 2 * 128 + 32;  // consumers + one producer warp
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Shape {
  static constexpr int RB = D * 2 < 128 ? D * 2 : 128;  // swizzle bytes
  static constexpr int CH = RB / 2;                     // columns a chunk
  static constexpr int NCH = D / CH;                    // chunks a row
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int BAR_BYTES = 8 * (1 + 3 * STAGES);
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES +
                              BAR_BYTES;
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

template <int D>
__device__ __forceinline__ void pv_step(float (&o)[D / 2],
                                        const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void pv_step<16>(float (&o)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  sm90::wgmma_rs_m64n16k16<1>(o, a, db, 1);
}
template <>
__device__ __forceinline__ void pv_step<32>(float (&o)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  sm90::wgmma_rs_m64n32k16<1>(o, a, db, 1);
}
template <>
__device__ __forceinline__ void pv_step<64>(float (&o)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  sm90::wgmma_rs_m64n64k16<1>(o, a, db, 1);
}
template <>
__device__ __forceinline__ void pv_step<128>(float (&o)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  sm90::wgmma_rs_m64n128k16<1>(o, a, db, 1);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_bf16(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     __nv_bfloat16* __restrict__ o, int H, int KV, int Sq,
                     int Sk, int o_sb, int o_sh, int o_ss, float scale_log2,
                     int causal, int d_out) {
  using S = Shape<D>;
  constexpr int RB = S::RB, CH = S::CH, NCH = S::NCH;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align1024(smem_raw);
  uint8_t* k_s = q_s + S::Q_BYTES;
  uint8_t* v_s = k_s + STAGES * S::KV_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(v_s + STAGES * S::KV_BYTES);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + STAGES;
  uint64_t* empty = bars + 1 + 2 * STAGES;

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = (int)((long long)h * KV / H);
  const int q0 = qt * BQ;
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int n_tiles = (k_end + BK - 1) / BK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer warp: one thread issues every TMA load ----
    if (tid == 256) {
      sm90::mbar_expect_tx(q_full, S::Q_BYTES);
      for (int c = 0; c < NCH; ++c)
        sm90::tma_load_4d(q_s + c * BQ * RB, &mq, q_full, c * CH, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % STAGES, round = j / STAGES;
        if (round > 0) sm90::mbar_wait(&empty[st], (round - 1) & 1);
        uint8_t* kt = k_s + st * S::KV_BYTES;
        uint8_t* vt = v_s + st * S::KV_BYTES;
        sm90::mbar_expect_tx(&k_full[st], S::KV_BYTES);
        for (int c = 0; c < NCH; ++c)
          sm90::tma_load_4d(kt + c * BK * RB, &mk, &k_full[st], c * CH,
                            j * BK, kvh, b);
        sm90::mbar_expect_tx(&v_full[st], S::KV_BYTES);
        for (int c = 0; c < NCH; ++c)
          sm90::tma_load_4d(vt + c * BK * RB, &mv, &v_full[st], c * CH,
                            j * BK, kvh, b);
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  const int wg = tid / 128, t = tid % 128;
  const int row0 = q0 + 64 * wg;
  const int r_lo = row0 + sm90::frag_row(0, t), r_hi = r_lo + 8;
  const int my_tiles =
      causal ? (min(Sk, row0 + 64) + BK - 1) / BK : n_tiles;
  const uint32_t q_addr = sm90::smem_addr(q_s) + wg * 64 * RB;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  sm90::mbar_wait(q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % STAGES;
    const uint32_t par = (j / STAGES) & 1;
    sm90::mbar_wait(&k_full[st], par);
    if (j < my_tiles) {
      const uint32_t k_addr = sm90::smem_addr(k_s + st * S::KV_BYTES);
      const uint32_t v_addr = sm90::smem_addr(v_s + st * S::KV_BYTES);
      // S = q k^T: 64 x 64, d / 16 k-steps, both operands K-major
      float s[32];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 / CH, off = (kk * 16 % CH) * 2;
        const uint64_t da =
            sm90::make_desc(q_addr + c * BQ * RB + off, 16, 8 * RB, RB);
        const uint64_t db =
            sm90::make_desc(k_addr + c * BK * RB + off, 16, 8 * RB, RB);
        sm90::wgmma_ss_m64n64k16<0, 0>(s, da, db, kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);

      // online softmax on the fragments (log2 units)
      const int k0 = j * BK;
      const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > row0);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = k0 + sm90::frag_col(i, t);
        const int row = (i / 2) % 2 ? r_hi : r_lo;
        float x = s[i] * scale_log2;
        if (edge && (col >= Sk || (causal && col > row))) x = -INFINITY;
        s[i] = x;
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
      }
      float alpha[2], m_use[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        // a row with nothing unmasked yet keeps exp2 arguments finite
        m_use[r] = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = exp2f(m[r] - m_use[r]);
        m[r] = m_new;
        l[r] *= alpha[r];  // this thread's share of the row sum
      }
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = exp2f(s[i] - m_use[(i / 2) % 2]);
        l[(i / 2) % 2] += s[i];
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          a[kk][q] = sm90::pack_bf16(s[8 * kk + 2 * q], s[8 * kk + 2 * q + 1]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];

      // O += P v: P from registers, v MN-major (LBO: next column chunk)
      sm90::mbar_wait(&v_full[st], par);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        pv_step<D>(acc, a[kk],
                   sm90::make_desc(v_addr + kk * 16 * RB, BK * RB, 8 * RB,
                                   RB));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
    }
    __syncwarp();
    if (t % 32 == 0) sm90::mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  __nv_bfloat16* ob = o + (long long)b * o_sb + (long long)h * o_sh;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int hi = (i / 2) % 2;
    const int row = hi ? r_hi : r_lo;
    const int col = sm90::frag_col(i, t);
    if (row < Sq && col < d_out) {
      *reinterpret_cast<uint32_t*>(ob + (long long)row * o_ss + col) =
          sm90::pack_bf16(acc[i] * inv[hi], acc[i + 1] * inv[hi]);
    }
  }
}

// dims of a (B, heads, S, d) view as a TMA tensor, innermost first, with
// a size-1 dimension given a stride that TMA takes (it is never stepped)
inline void tma_dims(long long d, long long S, long long heads, long long B,
                     int s_b, int s_h, int s_s, long long* dims,
                     long long* st) {
  dims[0] = d; dims[1] = S; dims[2] = heads; dims[3] = B;
  st[0] = S > 1 ? s_s : d;
  st[1] = heads > 1 ? s_h : st[0] * S;
  st[2] = B > 1 ? s_b : st[1] * heads;
}

// D: the head dim the block computes at; d: the tensors' own, d <= D. At
// d < D the maps give TMA the real extent d, so the chunks' columns d..D-1
// read as 0 (they add 0 to every score and produce output columns that
// are never stored).
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KV, int Sq, int Sk, int d, const int* st,
                   float scale, int causal, cudaStream_t stream) {
  using S = Shape<D>;
  long long dims[4], strides[3];
  CUtensorMap mq, mk, mv;
  tma_dims(d, Sq, H, B, st[0], st[1], st[2], dims, strides);
  cudaError_t err = sm90::make_map_bf16_4d(&mq, q, dims, strides, S::CH, BQ);
  if (err != cudaSuccess) return err;
  tma_dims(d, Sk, KV, B, st[3], st[4], st[5], dims, strides);
  err = sm90::make_map_bf16_4d(&mk, k, dims, strides, S::CH, BK);
  if (err != cudaSuccess) return err;
  tma_dims(d, Sk, KV, B, st[6], st[7], st[8], dims, strides);
  err = sm90::make_map_bf16_4d(&mv, v, dims, strides, S::CH, BK);
  if (err != cudaSuccess) return err;
  auto kern = flash_attention_bf16<D>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, S::SMEM, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)o, H, KV, Sq, Sk, st[9], st[10], st[11],
      scale * LOG2E, causal, d);
  return cudaGetLastError();
}

cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int KV, int Sq, int Sk, int D,
                       const int* st, float scale, int causal,
                       cudaStream_t stream) {
  switch (D) {
    case 16: return launch<16>(q, k, v, o, B, H, KV, Sq, Sk, 16, st, scale, causal, stream);
    case 32: return launch<32>(q, k, v, o, B, H, KV, Sq, Sk, 32, st, scale, causal, stream);
    case 64: return launch<64>(q, k, v, o, B, H, KV, Sq, Sk, 64, st, scale, causal, stream);
    // 80 is no multiple of the 64-column swizzled chunk: computed at 128
    // on zero-filled columns (see launch)
    case 80: return launch<128>(q, k, v, o, B, H, KV, Sq, Sk, 80, st, scale, causal, stream);
    case 128: return launch<128>(q, k, v, o, B, H, KV, Sq, Sk, 128, st, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bf16k

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
    err = dispatch_d(q, k, v, o, B, H, KV, Sq, Sk, D, st, scale, causal, s);
  else if (dtype == 1)
    err = bf16k::dispatch_d(q, k, v, o, B, H, KV, Sq, Sk, D, st, scale, causal, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

const char* flash_attention_launch_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
