// K3: the Mamba2 SSD intra-chunk step (state-space duality), for Hopper
// (sm_90a).
//
// Replaces src/repro/kernels/ssd_scan/kernel.py:35 _kernel, launched by
// ssd_intra_chunk (:66); the plain versions beside it are
// src/repro_torch/kernels/ssd_scan/ref.py::ssd_intra_chunk_ref (f32) and
// ::ssd_intra_chunk_ref_bf16 (the same operands rounded to bf16 where the
// bf16 kernel rounds them). Per (batch b, head h, chunk c) with
// Q = chunk length and t, u in the chunk:
//
//   cum      = cumsum(dt * A)                                   (Q,)
//   Y_intra  = ((C B^T) o M) (dt X),  M[t,u] = exp(cum_t - cum_u) if u <= t
//   S_chunk  = (B * dt * exp(cum_Q - cum))^T X                  (s, ph)
//   expcum   = exp(cum),  chunk_decay = exp(cum_Q)
//
//   X (Bt, H, S, ph) and B, C (Bt, G, S, s), f32 or bf16 alike, read
//   through (batch, head or group, position) strides, so neither the
//   (batch, head) fold nor the repeat of a group's B and C over its heads
//   is ever copied: head h reads group h / (H / G). dt (Bt, H, S) strided
//   and A (H,) f32; every output f32 and contiguous. S = nc * Q.
//   For u > t, cum_t - cum_u >= 0 and exp() overflows to inf where A is
//   large (A reaches -16 in Mamba2's init), so M is a select, never a
//   product with a 0/1 mask: inf * 0 is NaN.
//
// The dtype picks the kernel; neither is a fallback of the other.
//
// bf16: ssd_intra_chunk_bf16, tensor cores fed by TMA. One block per
// (chunk, head, batch), four warpgroups. One thread starts TMA loads of
// the chunk's C, B and X 64-row tiles (C and B of the head's group, 64 or
// 128 state columns; X padded to 64 columns by TMA's zero fill), each
// tile's three completing on its own mbarrier, while the block takes
// cum as a warp-shuffle scan. Then, in shared memory, dt * X is formed
// in place in bf16. Warpgroup w owns rows t of tile w and, for each u
// tile on or below the diagonal (10 of 16 at Q = 256), forms
// G = C_t B_u^T with wgmma m64n64k16 (K-major), weights it on the f32
// fragment by M (the select), rounds it to bf16 as the register A
// operand of Y_t += (G o M)(dt X)_u, wgmma m64n64k16 with dt X MN-major.
// Then B is scaled in place by exp(cum_Q - cum) in bf16 and the chunk
// state (B w)^T (dt X) is wgmma with the state axis as M (one warpgroup
// per 64 state rows, both operands MN-major), summed over the u tiles.
// Three operands are rounded to bf16: G o M, dt X and B w. Shared memory
// at s = 128, Q = 256: 160 KB of tiles.
//
// f32: ssd_intra_chunk_kernel, the first form of this kernel, on the
// CUDA cores, 256 threads. The cumsum is a Hillis-Steele scan in shared
// memory, in f64: M and the state weights are exps of differences of
// cum, which reaches ~-200 in a 256-step chunk, where an f32 cum loses
// ~1e-4 of M (enough to miss the 1e-4 bound against the sequential
// recurrence at S = 300). Y_intra goes by 64-row tiles of t and, for
// each, the 64-column tiles of u up to the diagonal: the block forms
// G = C_t . B_u in registers (thread (ty, tx) of a 16 x 16 grid owns rows
// ty + 16 i and columns tx + 16 j), weights it by M, stores it in shared
// memory and multiplies it into dt * X. The chunk state is a second pass
// over the u tiles with B weighted by dt * exp(cum_Q - cum) on load.
// Shared memory (dynamic): cum (256 f64) and dt (256), C and B tiles
// 64 x (s | 1), the weighted scores 64 x 65 and an X tile 64 x ph, f32:
// 102,144 B at s = 128, ph = 64.
//
// Bound on an H100 SXM at the serving shape (batch 8 x 32 heads, 1 group,
// S 512, ph 64, s 128, Q 256, X/B/C bf16): bytes, reads X 16,777,216, B
// and C 1,048,576 each (once per group), dt 524,288, A 128; writes
// Y_intra 33,554,432, S_chunk 16,777,216, expcum 524,288, chunk_decay
// 2,048: 70,256,768 B at 3.35 TB/s = 21.0 us a launch (the per-head
// interface, B and C read 32 times, moved 135,269,376 B: 40.4 us). FLOPs
// as the TPU kernel counts them (no causal skip) 15.0 G: 15 us at the
// bf16 tensor-core peak, ~224 us on the f32 CUDA cores.
//
// Limits (the wrapper checks them): Q <= 256, ph <= 64, s <= 128. Neither
// kernel allocates, both run on the caller's stream and never
// synchronise; the C entry returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int THREADS = 256;  // a 16 x 16 grid of threads
constexpr int QMAX = 256;     // chunk length
constexpr int TT = 64;        // rows (t) per tile
constexpr int TU = 64;        // columns (u) per tile
constexpr int PH_MAX = 64;
constexpr int S_MAX = 128;
constexpr int TP = PH_MAX / 16;  // ph columns per thread
constexpr int TS = S_MAX / 16;   // state rows per thread

inline int bs_stride(int s) { return s | 1; }  // odd: no bank conflicts

// Element strides of (batch, head or group, position) for X, B, C and dt.
struct Strides {
  int x[3], b[3], c[3], dt[3];
};

__global__ void __launch_bounds__(THREADS)
ssd_intra_chunk_kernel(const float* __restrict__ Xm,
                       const float* __restrict__ dtm,
                       const float* __restrict__ A,
                       const float* __restrict__ Bmm,
                       const float* __restrict__ Cmm, float* __restrict__ Y,
                       float* __restrict__ Sc, float* __restrict__ expcum,
                       float* __restrict__ decay, Strides sd, int hpg, int S,
                       int Q, int ph, int s) {
  extern __shared__ float smem[];
  const int st = s | 1;
  double* cum_s = reinterpret_cast<double*>(smem);  // [QMAX], f64
  float* dt_s = smem + 2 * QMAX;      // [QMAX]
  float* c_s = dt_s + QMAX;           // [TT][st]
  float* b_s = c_s + TT * st;         // [TU][st]
  float* g_s = b_s + TU * st;         // [TT][TU + 1]
  float* x_s = g_s + TT * (TU + 1);   // [TU][ph]

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int bh = b * gridDim.y + h, grp = h / hpg;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long row0 = (long long)bh * S + (long long)c * Q;  // outputs
  const long long pos0 = (long long)c * Q;
  // inputs: this (batch, head)'s X and dt, its group's B and C, from
  // position pos0 on
  const float* X = Xm + (long long)b * sd.x[0] + (long long)h * sd.x[1] +
               pos0 * sd.x[2];
  const float* Bm = Bmm + (long long)b * sd.b[0] + (long long)grp * sd.b[1] +
                pos0 * sd.b[2];
  const float* Cm = Cmm + (long long)b * sd.c[0] + (long long)grp * sd.c[1] +
                pos0 * sd.c[2];
  const float* dt = dtm + (long long)b * sd.dt[0] + (long long)h * sd.dt[1] +
                    pos0 * sd.dt[2];
  const float a = A[h];

  // ---- cum = cumsum(dt * A) over the chunk (Hillis-Steele) ----
  const float dtv = tid < Q ? dt[(long long)tid * sd.dt[2]] : 0.f;
  dt_s[tid] = dtv;
  cum_s[tid] = (double)(dtv * a);
  __syncthreads();
  for (int off = 1; off < Q; off <<= 1) {
    const double add = (tid >= off && tid < Q) ? cum_s[tid - off] : 0.0;
    __syncthreads();
    cum_s[tid] += add;
    __syncthreads();
  }
  if (tid < Q) expcum[row0 + tid] = expf((float)cum_s[tid]);
  const double cum_last = cum_s[Q - 1];
  if (tid == 0) decay[(long long)bh * nc + c] = expf((float)cum_last);

  // ---- Y_intra, by 64-row tiles of t ----
  for (int t0 = 0; t0 < Q; t0 += TT) {
    __syncthreads();
    for (int idx = tid; idx < TT * s; idx += THREADS) {
      const int r = idx / s, n = idx % s, t = t0 + r;
      c_s[r * st + n] =
          t < Q ? Cm[(long long)t * sd.c[2] + n] : 0.f;
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
        b_s[r * st + n] =
            u < Q ? Bm[(long long)u * sd.b[2] + n] : 0.f;
      }
      for (int idx = tid; idx < TU * ph; idx += THREADS) {
        const int r = idx / ph, p = idx % ph, u = u0 + r;
        x_s[r * ph + p] =
            u < Q ? dt_s[u] * X[(long long)u * sd.x[2] + p] : 0.f;
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
              keep ? g[i][j] * expf((float)(cum_s[t] - cum_s[u])) : 0.f;
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
          u < Q ? Bm[(long long)u * sd.b[2] + n] *
                      (dt_s[u] * expf((float)(cum_last - cum_s[u])))
                : 0.f;
    }
    for (int idx = tid; idx < TU * ph; idx += THREADS) {
      const int r = idx / ph, p = idx % ph, u = u0 + r;
      x_s[r * ph + p] =
          u < Q ? X[(long long)u * sd.x[2] + p] : 0.f;
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

cudaError_t launch_f32(const void* X, const float* dt, const float* A,
                       const void* Bm, const void* Cm, float* Y, float* Sc,
                       float* expcum, float* decay, int Bt, int H, int G,
                       int S, int Q, int ph, int s, const Strides& sd,
                       cudaStream_t stream) {
  const int st = bs_stride(s);
  const int bytes =
      (3 * QMAX + 2 * TT * st + TT * (TU + 1) + TU * ph) * (int)sizeof(float);
  auto kern = ssd_intra_chunk_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(S / Q, H, Bt);
  kern<<<grid, THREADS, bytes, stream>>>((const float*)X, dt, A,
                                         (const float*)Bm, (const float*)Cm,
                                         Y, Sc, expcum, decay, sd, H / G, S,
                                         Q, ph, s);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ bf16
namespace bf16k {

constexpr int T = 64;                      // rows of a tile (t or u)
constexpr int NT_MAX = QMAX / T;           // tiles a chunk
constexpr int WG = 4;                      // consumer warpgroups
constexpr int THREADS = WG * 128;
constexpr int TILE_BYTES = T * 128;        // a 64 x 64 bf16 box, 128-B rows

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// Scales the 32 bf16 of one half (64 bytes) of a 128-byte tile row by w,
// rounding to bf16. The swizzle keeps a row's bytes in its row, so the
// order of the 32 values does not matter.
__device__ __forceinline__ void scale_half_row(uint8_t* p, float w) {
  uint4* v = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint4 x = v[q];
    uint32_t* u = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u[e]));
      u[e] = sm90::pack_bf16(f.x * w, f.y * w);
    }
    v[q] = x;
  }
}

// One block per (chunk, head, batch); SP = the state size padded to 64 or
// 128 (one or two 64-column chunks of B and C).
template <int SP>
__global__ void __launch_bounds__(THREADS, 1)
ssd_intra_chunk_bf16(const __grid_constant__ CUtensorMap mx,
                     const __grid_constant__ CUtensorMap mb,
                     const __grid_constant__ CUtensorMap mc,
                     const float* __restrict__ dtm, int dt_sb, int dt_sh,
                     int dt_ss, const float* __restrict__ A,
                     float* __restrict__ Y, float* __restrict__ Sc,
                     float* __restrict__ expcum, float* __restrict__ decay,
                     int hpg, int S, int Q, int ph, int s) {
  constexpr int NCS = SP / 64;             // column chunks of B and C
  extern __shared__ uint8_t smem_raw[];
  __shared__ float cum_s[QMAX], dt_s[QMAX], warp_tot[THREADS / 32];
  __shared__ alignas(8) uint64_t bars[NT_MAX];

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int bh = b * gridDim.y + h, grp = h / hpg;
  const int NT = (Q + T - 1) / T;
  const long long pos0 = (long long)c * Q;
  uint8_t* c_s = align1024(smem_raw);      // [NT][NCS] C tiles
  uint8_t* b_s = c_s + NT * NCS * TILE_BYTES;  // [NT][NCS] B tiles
  uint8_t* x_s = b_s + NT * NCS * TILE_BYTES;  // [NT] X tiles
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;

  // ---- one thread starts every TMA load of the chunk ----
  if (tid == 0) {
    for (int i = 0; i < NT; ++i) sm90::mbar_init(&bars[i], 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < NT; ++i) {
      const int pos = (int)pos0 + i * T;
      sm90::mbar_expect_tx(&bars[i], (2 * NCS + 1) * TILE_BYTES);
      for (int j = 0; j < NCS; ++j) {
        sm90::tma_load_4d(c_s + (i * NCS + j) * TILE_BYTES, &mc, &bars[i],
                          64 * j, pos, grp, b);
        sm90::tma_load_4d(b_s + (i * NCS + j) * TILE_BYTES, &mb, &bars[i],
                          64 * j, pos, grp, b);
      }
      sm90::tma_load_4d(x_s + i * TILE_BYTES, &mx, &bars[i], 0, pos, h, b);
    }
  }

  // ---- cum = cumsum(dt * A): a warp-shuffle scan while the tiles land --
  const float* dt = dtm + (long long)b * dt_sb + (long long)h * dt_sh;
  const int lane = tid % 32, warp = tid / 32;
  const float dv = tid < Q ? dt[(pos0 + tid) * dt_ss] : 0.f;
  float v = __fmul_rn(dv, A[h]);  // never fused into the scan's adds
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += n;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += warp_tot[w];
  if (tid < QMAX) {
    dt_s[tid] = dv;                      // 0 past the chunk's end
    cum_s[tid] = tid < Q ? v : 0.f;
  }
  __syncthreads();
  const float cum_last = cum_s[Q - 1];
  if (tid < Q) expcum[(long long)bh * S + pos0 + tid] = expf(cum_s[tid]);
  if (tid == 0) decay[(long long)bh * nc + c] = expf(cum_last);

  // ---- dt * X in place, in bf16, once the tiles are in ----
  for (int i = 0; i < NT; ++i) sm90::mbar_wait(&bars[i], 0);
  if (wg < NT) {
    const int row = wg * T + t / 2;
    scale_half_row(x_s + wg * TILE_BYTES + (t / 2) * 128 + (t % 2) * 64,
                   dt_s[row]);
  }
  sm90::fence_proxy_async();
  __syncthreads();

  const uint32_t c_addr = sm90::smem_addr(c_s), b_addr = sm90::smem_addr(b_s),
                 x_addr = sm90::smem_addr(x_s);

  // ---- Y_intra: warpgroup wg owns rows t in [64 wg, 64 wg + 64) ----
  if (wg < NT) {
    float y[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) y[i] = 0.f;
    for (int u = 0; u <= wg; ++u) {      // tiles on or below the diagonal
      // G = C_t B_u^T, both K-major
      float g[32];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < SP / 16; ++kk) {
        const int j = kk / 4, off = (kk % 4) * 32;
        sm90::wgmma_ss_m64n64k16<0, 0>(
            g,
            sm90::make_desc(c_addr + (wg * NCS + j) * TILE_BYTES + off, 16,
                            1024, 128),
            sm90::make_desc(b_addr + (u * NCS + j) * TILE_BYTES + off, 16,
                            1024, 128),
            kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(g);
      // G o M, M[t,u] = exp(cum_t - cum_u) for u <= t: a select, since
      // exp overflows above the diagonal and inf * 0 is NaN
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int tt = wg * T + sm90::frag_row(i, t);
        const int uu = u * T + sm90::frag_col(i, t);
        const float ct = cum_s[tt];
        const bool row_ok = tt < Q;
        const float g0 =
            row_ok && uu <= tt ? g[i] * expf(ct - cum_s[uu]) : 0.f;
        const float g1 =
            row_ok && uu + 1 <= tt ? g[i + 1] * expf(ct - cum_s[uu + 1])
                                   : 0.f;
        a[i / 8][(i % 8) / 2] = sm90::pack_bf16(g0, g1);
      }
      // Y_t += (G o M) (dt X)_u: A from registers, dt X MN-major
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs_m64n64k16<1>(
            y, a[kk],
            sm90::make_desc(x_addr + u * TILE_BYTES + kk * 16 * 128,
                            TILE_BYTES, 1024, 128),
            1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(y);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int tt = wg * T + sm90::frag_row(i, t);
      const int p = sm90::frag_col(i, t);
      if (tt < Q && p < ph) Y[((long long)bh * S + pos0 + tt) * ph + p] = y[i];
    }
  }
  __syncthreads();                       // every read of raw B is done

  // ---- B * exp(cum_Q - cum) in place, in bf16 (0 past the chunk) ----
  if (wg < NT) {
    const int u = wg * T + t / 2;
    const float w = u < Q ? expf(cum_last - cum_s[u]) : 0.f;
#pragma unroll
    for (int j = 0; j < NCS; ++j)
      scale_half_row(
          b_s + (wg * NCS + j) * TILE_BYTES + (t / 2) * 128 + (t % 2) * 64, w);
  }
  sm90::fence_proxy_async();
  __syncthreads();

  // ---- S_chunk = (B w)^T (dt X): warpgroup wg owns state rows
  // [64 wg, 64 wg + 64); both operands MN-major, summed over u ----
  if (wg < NCS) {
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    sm90::wgmma_fence();
    for (int u = 0; u < NT; ++u) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_ss_m64n64k16<1, 1>(
            sc,
            sm90::make_desc(b_addr + (u * NCS + wg) * TILE_BYTES +
                                kk * 16 * 128,
                            TILE_BYTES, 1024, 128),
            sm90::make_desc(x_addr + u * TILE_BYTES + kk * 16 * 128,
                            TILE_BYTES, 1024, 128),
            1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    float* out = Sc + ((long long)bh * nc + c) * s * ph;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int n = wg * 64 + sm90::frag_row(i, t);
      const int p = sm90::frag_col(i, t);
      if (n < s && p < ph) out[n * ph + p] = sc[i];
    }
  }
}

inline void tma_dims(long long inner, long long S, long long heads,
                     long long B, const int* st, long long* dims,
                     long long* str) {
  dims[0] = inner; dims[1] = S; dims[2] = heads; dims[3] = B;
  // a size-1 dimension is never stepped: give it a stride TMA takes
  str[0] = S > 1 ? st[2] : 8;
  str[1] = heads > 1 ? st[1] : str[0] * S;
  str[2] = B > 1 ? st[0] : str[1] * heads;
}

template <int SP>
cudaError_t launch(const void* X, const float* dt, const float* A,
                   const void* Bm, const void* Cm, float* Y, float* Sc,
                   float* expcum, float* decay, int Bt, int H, int G, int S,
                   int Q, int ph, int s, const Strides& sd,
                   cudaStream_t stream) {
  long long dims[4], str[3];
  CUtensorMap mx, mb, mc;
  tma_dims(ph, S, H, Bt, sd.x, dims, str);
  cudaError_t err = sm90::make_map_bf16_4d(&mx, X, dims, str, 64, T);
  if (err != cudaSuccess) return err;
  tma_dims(s, S, G, Bt, sd.b, dims, str);
  err = sm90::make_map_bf16_4d(&mb, Bm, dims, str, 64, T);
  if (err != cudaSuccess) return err;
  tma_dims(s, S, G, Bt, sd.c, dims, str);
  err = sm90::make_map_bf16_4d(&mc, Cm, dims, str, 64, T);
  if (err != cudaSuccess) return err;
  const int NT = (Q + T - 1) / T;
  const int bytes = 1024 + NT * (2 * (SP / 64) + 1) * TILE_BYTES;
  auto kern = ssd_intra_chunk_bf16<SP>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(S / Q, H, Bt);
  kern<<<grid, THREADS, bytes, stream>>>(
      mx, mb, mc, dt, sd.dt[0], sd.dt[1], sd.dt[2], A, Y, Sc, expcum, decay,
      H / G, S, Q, ph, s);
  return cudaGetLastError();
}

}  // namespace bf16k

}  // namespace

extern "C" {

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the tensor-core
// kernel); X, B and C alike. X (Bt, H, S, ph), B and C (Bt, G, S, s) with
// H % G == 0 (head h reads group h / (H / G)), dt (Bt, H, S), A (H,)
// contiguous; the strides are element strides of (batch, head or group,
// position), the last dimension contiguous. Outputs contiguous: Y
// (Bt, H, S, ph), Sc (Bt, H, nc, s, ph), expcum (Bt, H, S), decay
// (Bt, H, nc). S % Q == 0, Q <= 256, ph <= 64, s <= 128.
int ssd_intra_chunk_launch(const void* X, const void* dt, const void* A,
                           const void* Bm, const void* Cm, void* Y, void* Sc,
                           void* expcum, void* decay, int dtype, int Bt,
                           int H, int G, int S, int Q, int ph, int s,
                           int x_sb, int x_sh, int x_ss, int b_sb, int b_sh,
                           int b_ss, int c_sb, int c_sh, int c_ss, int dt_sb,
                           int dt_sh, int dt_ss, void* stream) {
  if (Q < 1 || Q > QMAX || S % Q != 0 || ph < 1 || ph > PH_MAX || s < 1 ||
      s > S_MAX || G < 1 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  const Strides sd = {{x_sb, x_sh, x_ss},
                      {b_sb, b_sh, b_ss},
                      {c_sb, c_sh, c_ss},
                      {dt_sb, dt_sh, dt_ss}};
  cudaStream_t st = (cudaStream_t)stream;
  const float *dtf = (const float*)dt, *Af = (const float*)A;
  float *Yf = (float*)Y, *Scf = (float*)Sc, *ef = (float*)expcum,
        *df = (float*)decay;
  cudaError_t err;
  if (dtype == 0)
    err = launch_f32(X, dtf, Af, Bm, Cm, Yf, Scf, ef, df, Bt, H, G, S, Q, ph,
                     s, sd, st);
  else if (dtype == 1 && s <= 64)
    err = bf16k::launch<64>(X, dtf, Af, Bm, Cm, Yf, Scf, ef, df, Bt, H, G, S,
                            Q, ph, s, sd, st);
  else if (dtype == 1)
    err = bf16k::launch<128>(X, dtf, Af, Bm, Cm, Yf, Scf, ef, df, Bt, H, G,
                             S, Q, ph, s, sd, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

const char* ssd_intra_chunk_launch_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
