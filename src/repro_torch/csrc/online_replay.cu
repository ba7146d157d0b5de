// Online's in-slot replay (Alg. 2, the scan engine's sequential step) for
// one H100, plain CUDA C++ behind a C entry point (loaded with ctypes).
//
// Replaces no TPU kernel: it is the body of the JAX package's
// OnlinePolicy.scan_step (src/repro/core/policies.py:487-517), a lax.scan
// over the users of a slot in index order (`slow`) or an elementwise rule
// when H == 0 (`fast`), which XLA compiles for the TPU. Eager PyTorch has
// no loop that stays on the device, so the port replays the slot here:
// without a kernel the walk would be one launch per user per slot, or a
// round trip to the host every slot.
//
// The function, per config row, with j the users started so far this slot:
//   do_i = w_i && b_i + H * gap_vec[j] <= r_i + H * g_i
//   op_i = do_i ? gap_vec[j] : g_i                 (waiting users only)
//   j   += do_i
//   gap_sum = the sum of the waiting users' op_i, in user order, in
//             numpy's summation order (np.sum over a contiguous array)
// where b_i = V P_sched t_d - Q, r_i = V P_idle t_d, g_i = idle_gap_i + eps.
// With H == 0 the gap terms add exactly 0 and the same function gives the
// elementwise decisions of the reference's `fast` branch, so one launch a
// slot covers both branches and H is read here, never by the host. The
// gap sum is numpy's order, as the numpy engine's decide_batch sums
// (np.sum of its gaps): blocks of 8,192 operands added left to right to
// 0.0, each block by numpy's pairwise_sum (leaves of at most 128: below 8
// a serial sum from 0.0, else eight strided accumulators combined
// ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)) and the tail added in order; larger
// blocks split at n/2 - (n/2)%8). The plain version writes the same order
// out in Python (kernels/online_replay/ref.py).
//
// Every product and sum is __dmul_rn / __dadd_rn: nvcc contracts a*b + c
// into an fma by default, which skips the product's rounding that the
// reference forces with its traced zero (policies.py:257-268, 479-481) and
// the host engines round by construction. With them the kernel equals its
// plain version bit for bit.
//
// Design (the threshold form, src/repro_torch/core/lyapunov.py
// decide_batch). Where H is finite and >= 0 and gap_vec[0 .. W-1] is
// non-decreasing (W the row's waiting users) with H * gap_vec[0] and
// H * gap_vec[W-1] finite, cost_i(j) = b_i + H gap_vec[j] is
// non-decreasing in j (IEEE products and sums are monotone) and never NaN
// unless b_i is, so the comparison holds for a prefix of j: user i starts
// iff j_i <= K_i, the largest j <= w_i (w_i: waiting users before i) at
// which it holds. Users for which it holds at w_i always start; users for
// which it fails at 0 never do; only the rest ("undecided") depend on the
// order, and for them j_i = A_i + m (A_i: always-users before i; m:
// undecided users before i that started), so the walk over the
// undecided users alone is in integers: x = m <= K_i - A_i; m += x. One
// cooperative launch, a persistent grid (every block resident) over all
// SMs, phases handed off by grid-wide barriers:
//   (a) per tile of 1,024 users: waiting count; the first j in the tile
//       with !(gap_vec[j] <= gap_vec[j+1]) (NaN fails);
//   (b) per tile: the row's W and its check; w_i; for each waiting user
//       K_i by bisection in [-1, w_i] (probing w_i and 0 first), its
//       class; per-tile always and undecided counts;
//   (c) per tile: A_i and u_i (undecided users before i); the undecided
//       users compacted in user order with T_i = K_i - A_i;
//   (d) one thread a row walks the undecided users (staged in shared
//       memory, read 8 at a time into registers a group ahead, so that
//       only the step's two integer ops are on the chain) and writes
//       M[k], the starts among the first k of them;
//   (e) per tile: do_i (always, never, or M[u_i+1] - M[u_i]), j_i =
//       A_i + M[u_i] and op_i written at the waiting position w_i;
//   (f) per (row, block of 8,192 operands): numpy's pairwise tree, level
//       by level in shared memory (each leaf of <= 128 by 8 lanes, one
//       of numpy's 8 accumulators a lane, combined by shuffles); the
//       last block of a row to finish (an atomic ticket) adds the blocks
//       left to right and writes gap_sum.
// A row that fails the check takes the literal walk in (d) (one thread,
// today's rule over every user, writing do_i and op_i), and (f) sums its
// operands alike: the same function either way. `rows` records, per row,
// the path taken (1 threshold, 0 literal), W and the always and undecided
// counts; `sync` keeps the barrier's words and counts the rows each path
// took since it was last zeroed (tests and chip_smoke.py read both; the
// engine never does).
//
// Bound: bytes, 34 a user (waiting, base, rhs, gap_idle, gap_vec read,
// start written) at 3.35 TB/s; operations, the chain that remains
// serial: the undecided users of the fullest row, one dependent
// `m += (m <= T)` step each (walk_chain_launch times that step on this
// card), then the gap sum's dependency depth in f64 adds (the leaf's
// accumulator chain, the pairwise tree, the blocks added in order;
// dadd_chain_launch times one dependent DADD). Five grid barriers, the
// bisections' L2 round trips and the ticket sit on top (PERF.md has the
// kernel's time against the bound).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;        // threads a block
constexpr int PER = 4;              // consecutive users a thread
constexpr int TILE = THREADS * PER; // users a tile
constexpr int NW = THREADS / 32;    // warps a block
constexpr int CH = 2048;            // undecided users staged at a time
constexpr int SUMBLOCK = 8192;      // numpy's reduction buffer
constexpr int LEAF = 128;           // numpy's PW_BLOCKSIZE
constexpr int LEVELS = 8;           // pairwise-tree depth for <= 8,192
constexpr int LEVEL_NODES = 64;     // nodes a level for <= 8,192
constexpr int BIG = 0x7fffffff;
// rowi: per-row scratch words
constexpr int R_W = 0, R_THR = 1, R_A = 2, R_U = 3, R_TICKET = 4,
              R_WORDS = 8;

struct Args {
  const uint8_t* waiting;
  const double* base;
  const double* rhs;
  const double* gap_idle;
  const double* gap_vec;
  const double* H;
  uint8_t* start;
  double* gap_sum;
  int* rows;                  // (B, 4): path, W, always, undecided
  unsigned long long* sync;   // barrier count, generation; rows per path
  unsigned long long* trace;  // null, or 7 %globaltimer stamps (ns)
  // scratch (the wrapper's one buffer, carved by scratch_layout)
  int* tile_w;    // (B, NT) waiting users a tile
  int* tile_v;    // (B, NT) first gap_vec descent in the tile, or BIG
  int* tile_au;   // (B, NT) always | undecided << 16 a tile
  int* user_w;    // (B, n) waiting users before i
  int* user_k;    // (B, n) K_i (-1: never; >= w_i: always)
  int* user_a;    // (B, n) always-users before i
  int* user_u;    // (B, n) undecided users before i
  int* list_t;    // (B, n) T of the undecided users, compacted
  int* list_m;    // (B, n + 1) starts among the first k undecided users
  double* ops;    // (B, n) the waiting users' operands, compacted
  double* part;   // (B, NS) each block of 8,192 operands' sum
  int* rowi;      // (B, R_WORDS)
  long long B, n, NT, NS;
};

struct Layout {
  long long NT, NS;
  size_t off[12];   // byte offsets of the scratch arrays in Args order
  size_t bytes;
};

Layout scratch_layout(long long B, long long n) {
  Layout L;
  L.NT = (n + TILE - 1) / TILE;
  L.NS = n > 0 ? (n + SUMBLOCK - 1) / SUMBLOCK : 1;
  const size_t sizes[12] = {
      4 * (size_t)(B * L.NT), 4 * (size_t)(B * L.NT), 4 * (size_t)(B * L.NT),
      4 * (size_t)(B * n), 4 * (size_t)(B * n), 4 * (size_t)(B * n),
      4 * (size_t)(B * n), 4 * (size_t)(B * n), 4 * (size_t)(B * (n + 1)),
      8 * (size_t)(B * n), 8 * (size_t)(B * L.NS), 4 * (size_t)(B * R_WORDS)};
  size_t at = 0;
  for (int k = 0; k < 12; ++k) {
    L.off[k] = at;
    at += (sizes[k] + 255) / 256 * 256;
  }
  L.bytes = at;
  return L;
}

struct TreeSmem {
  int lo[LEVELS][LEVEL_NODES];
  int len[LEVELS][LEVEL_NODES];
  int child[LEVELS][LEVEL_NODES];
  double val[LEVELS][LEVEL_NODES];
  int cnt[LEVELS];
};

struct WalkSmem {
  int t[CH];
  int m[CH];
};

union __align__(16) PhaseSmem {
  TreeSmem tree;
  WalkSmem walk;
};

// ---- block-wide helpers (every thread of the block calls them) ----------
__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ int block_sum(int v, int* s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) s[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_sum(lane < NW ? s[lane] : 0);
    if (lane == 0) s[NW] = v;
  }
  __syncthreads();
  v = s[NW];
  __syncthreads();
  return v;
}

__device__ int block_min(int v, int* s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_min(v);
  if (lane == 0) s[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_min(lane < NW ? s[lane] : BIG);
    if (lane == 0) s[NW] = v;
  }
  __syncthreads();
  v = s[NW];
  __syncthreads();
  return v;
}

// exclusive prefix of v over the block in thread order; *total the sum
__device__ int block_scan(int v, int* s, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < NW ? s[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    if (lane < NW) s[lane] = t;
  }
  __syncthreads();
  const int excl = x - v + (warp ? s[warp - 1] : 0);
  *total = s[NW - 1];
  __syncthreads();
  return excl;
}

// Grid-wide barrier of a cooperative launch (every block resident):
// sync[0] counts arrivals, sync[1] is the generation. The last block to
// arrive resets the count and moves the generation on; the rest wait for
// it. A wait past ~10 s traps (a fault, never a hang).
__device__ void grid_sync(unsigned long long* sync) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned long long* gen = sync + 1;
    const unsigned long long g = *gen;
    __threadfence();
    if (atomicAdd(sync, 1ull) == (unsigned long long)gridDim.x - 1) {
      atomicExch(sync, 0ull);
      __threadfence();
      atomicAdd(sync + 1, 1ull);
    } else {
      const long long t0 = clock64();
      while (*gen == g) {
        __nanosleep(64);
        if (clock64() - t0 > 20000000000LL) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// the comparison of the walk at lag index j
__device__ __forceinline__ bool holds(double b, double c, double h,
                                      const double* gv, int j) {
  return __dadd_rn(b, __dmul_rn(h, __ldg(gv + j))) <= c;
}

// one step of the walk over the undecided users: m + (m <= t), branch-free
__device__ __forceinline__ int walk_step(int m, int t) {
  return m + (int)((unsigned)(m - t - 1) >> 31);
}

// T past the last undecided user of a staged run: m <= PAD never holds
constexpr int PAD = -(1 << 30);

// The walk over groups of 8 staged T (shared memory, 16-byte aligned, a
// multiple of 8 entries): each group's T in registers, the next group's
// loaded before this one's 8 steps, so that only the steps' integer ops
// are on the chain; mo[k] = m before step k. Returns m after the run.
__device__ __forceinline__ int walk_run(const int* t, int* mo, int groups,
                                        int m) {
  const int4* t4 = reinterpret_cast<const int4*>(t);
  int4* m4 = reinterpret_cast<int4*>(mo);
  int4 na = t4[0], nb = t4[1];
  for (int g = 0; g < groups; ++g) {
    const int4 a = na, b = nb;
    if (g + 1 < groups) {
      na = t4[2 * g + 2];
      nb = t4[2 * g + 3];
    }
    int4 oa, ob;
    oa.x = m; m = walk_step(m, a.x);
    oa.y = m; m = walk_step(m, a.y);
    oa.z = m; m = walk_step(m, a.z);
    oa.w = m; m = walk_step(m, a.w);
    ob.x = m; m = walk_step(m, b.x);
    ob.y = m; m = walk_step(m, b.y);
    ob.z = m; m = walk_step(m, b.z);
    ob.w = m; m = walk_step(m, b.w);
    m4[2 * g] = oa;
    m4[2 * g + 1] = ob;
  }
  return m;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// numpy's pairwise_sum of a[0 .. L) (L <= 8,192) by the whole block: the
// tree's nodes level by level (a node longer than 128 has two children,
// split at L/2 - (L/2)%8), the leaves (at most 128 each), then each
// level's sums bottom up. Returns the root's sum to every thread.
__device__ double block_pairwise(const double* a, int L, TreeSmem& s,
                                 int* red) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    s.lo[0][0] = 0;
    s.len[0][0] = L;
    s.cnt[0] = 1;
  }
  __syncthreads();
  int levels = 1;
  for (int d = 0; d + 1 < LEVELS; ++d) {
    const int cnt = s.cnt[d];
    int lo = 0, len = 0, ch = 0;
    if (tid < cnt) {
      lo = s.lo[d][tid];
      len = s.len[d][tid];
      ch = len > LEAF ? 2 : 0;
    }
    int tot;
    const int at = block_scan(ch, red, &tot);
    if (tid < cnt) {
      s.child[d][tid] = at;
      if (ch) {
        const int n2 = len / 2 - (len / 2) % 8;
        s.lo[d + 1][at] = lo;
        s.len[d + 1][at] = n2;
        s.lo[d + 1][at + 1] = lo + n2;
        s.len[d + 1][at + 1] = len - n2;
      }
    }
    if (tid == 0) s.cnt[d + 1] = tot;
    __syncthreads();
    if (tot == 0) break;
    levels = d + 2;
  }
  // the leaves, 8 lanes a leaf: lane q keeps numpy's accumulator r_q
  // (a[q], then every 8th), the lanes combine them as
  // ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)) by shuffles (IEEE addition
  // commutes exactly) and lane 0 adds the tail in order; below 8, lane 0
  // sums from 0.0
  const int q = tid & 7, group = tid >> 3;
  for (int d = 0; d < levels; ++d) {
    const int cnt = s.cnt[d];
    for (int k0 = 0; k0 < cnt; k0 += THREADS / 8) {   // warp-uniform
      const int k = k0 + group;
      const bool leaf = k < cnt && s.len[d][k] <= LEAF;
      const int lo = leaf ? s.lo[d][k] : 0, len = leaf ? s.len[d][k] : 0;
      const int end = len - len % 8;
      double r = 0.0;
      if (len >= 8) {
        r = __ldcg(a + lo + q);
#pragma unroll 4
        for (int i = 8; i < end; i += 8)
          r = __dadd_rn(r, __ldcg(a + lo + i + q));
      }
      __syncwarp();
      r = __dadd_rn(r, __shfl_xor_sync(0xffffffffu, r, 1));
      r = __dadd_rn(r, __shfl_xor_sync(0xffffffffu, r, 2));
      r = __dadd_rn(r, __shfl_xor_sync(0xffffffffu, r, 4));
      if (leaf && q == 0) {
        double res = len >= 8 ? r : 0.0;
        for (int i = end; i < len; ++i) res = __dadd_rn(res, __ldcg(a + lo + i));
        s.val[d][k] = res;
      }
    }
  }
  __syncthreads();
  for (int d = levels - 2; d >= 0; --d) {
    if (tid < s.cnt[d] && s.len[d][tid] > LEAF) {
      const int c = s.child[d][tid];
      s.val[d][tid] = __dadd_rn(s.val[d + 1][c], s.val[d + 1][c + 1]);
    }
    __syncthreads();
  }
  return s.val[0][0];
}

// the literal walk of one row by one thread (a row that fails the check)
__device__ void literal_walk(const Args& a, long long row, double h) {
  const long long n = a.n;
  const uint8_t* w = a.waiting + row * n;
  const double* b = a.base + row * n;
  const double* r = a.rhs + row * n;
  const double* gi = a.gap_idle + row * n;
  const double* gv = a.gap_vec + row * (n + 1);
  uint8_t* st = a.start + row * n;
  double* ops = a.ops + row * n;
  long long j = 0, pos = 0;
  for (long long i = 0; i < n; ++i) {
    bool d = false;
    if (w[i]) {
      const double g = gi[i];
      const double gj = gv[j];
      d = __dadd_rn(b[i], __dmul_rn(h, gj)) <=
          __dadd_rn(r[i], __dmul_rn(h, g));
      ops[pos++] = d ? gj : g;
      j += d;
    }
    st[i] = (uint8_t)d;
  }
}

__global__ void __launch_bounds__(THREADS)
online_replay_kernel(const Args a) {
  __shared__ PhaseSmem sm;
  __shared__ int red[NW + 1];
  const int tid = threadIdx.x;
  const long long n = a.n, NT = a.NT, NS = a.NS, B = a.B;
  if (n == 0) {   // no user: nothing waits, nothing to sum
    for (long long row = blockIdx.x; row < B; row += gridDim.x)
      if (tid == 0) {
        a.gap_sum[row] = 0.0;
        int* rec = a.rows + row * 4;
        rec[0] = 1;
        rec[1] = rec[2] = rec[3] = 0;
        atomicAdd(a.sync + 2, 1ull);
      }
    return;
  }
  const long long tiles = B * NT;
  const bool stamp = a.trace && blockIdx.x == 0 && tid == 0;
  if (stamp) a.trace[0] = global_ns();

  // (a) waiting counts and the first descent of gap_vec, a tile
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row = t / NT, i0 = (t % NT) * TILE + tid * PER;
    const uint8_t* w = a.waiting + row * n;
    const double* gv = a.gap_vec + row * (n + 1);
    int cw = 0, viol = BIG;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const long long i = i0 + q;
      if (i < n) {
        cw += w[i] != 0;
        if (!(__ldg(gv + i) <= __ldg(gv + i + 1)) && viol == BIG)
          viol = (int)i;
      }
    }
    cw = block_sum(cw, red);
    viol = block_min(viol, red);
    if (tid == 0) {
      a.tile_w[t] = cw;
      a.tile_v[t] = viol;
      if (t % NT == 0) a.rowi[row * R_WORDS + R_TICKET] = 0;
    }
  }
  grid_sync(a.sync);
  if (stamp) a.trace[1] = global_ns();

  // (b) the row's check, w_i, K_i and each waiting user's class
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row = t / NT, tt = t % NT, i0 = tt * TILE + tid * PER;
    int tot = 0, pre = 0, vmin = BIG;
    for (long long k = tid; k < NT; k += THREADS) {
      const int c = __ldcg(a.tile_w + row * NT + k);
      tot += c;
      if (k < tt) pre += c;
      vmin = min(vmin, __ldcg(a.tile_v + row * NT + k));
    }
    tot = block_sum(tot, red);
    pre = block_sum(pre, red);
    vmin = block_min(vmin, red);
    const double h = a.H[row];
    const double* gv = a.gap_vec + row * (n + 1);
    const int W = tot;
    bool thr = isfinite(h) && h >= 0.0 && (W <= 1 || vmin >= W - 1);
    if (thr && W > 0)
      thr = isfinite(__dmul_rn(h, __ldg(gv))) &&
            isfinite(__dmul_rn(h, __ldg(gv + W - 1)));
    if (tid == 0 && tt == 0) {
      a.rowi[row * R_WORDS + R_W] = W;
      a.rowi[row * R_WORDS + R_THR] = thr;
    }
    if (!thr) continue;
    const uint8_t* w = a.waiting + row * n;
    bool wq[PER];
    int cnt = 0;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      wq[q] = i0 + q < n && w[i0 + q];
      cnt += wq[q];
    }
    int unused;
    int run = pre + block_scan(cnt, red, &unused);
    int wpos[PER], K[PER], lo[PER], hi[PER];
    double bq[PER], cq[PER];
    bool top[PER], bot[PER];
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      wpos[q] = run;
      run += wq[q];
      lo[q] = hi[q] = 0;
      K[q] = -1;
      if (wq[q]) {
        const long long i = row * n + i0 + q;
        bq[q] = a.base[i];
        cq[q] = __dadd_rn(a.rhs[i], __dmul_rn(h, a.gap_idle[i]));
        top[q] = holds(bq[q], cq[q], h, gv, wpos[q]);
        bot[q] = holds(bq[q], cq[q], h, gv, 0);
      }
    }
    int na = 0, nu = 0;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      if (!wq[q]) continue;
      if (top[q]) {
        K[q] = wpos[q];
        ++na;
      } else if (bot[q]) {   // undecided: holds at 0, fails at w_i
        K[q] = 0;
        hi[q] = wpos[q];
        ++nu;
      }
    }
    for (;;) {   // bisection, the lanes in step: holds(lo), fails(hi)
      bool more = false;
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        if (hi[q] - lo[q] > 1) {
          more = true;
          const int mid = (lo[q] + hi[q]) >> 1;
          if (holds(bq[q], cq[q], h, gv, mid)) lo[q] = mid;
          else hi[q] = mid;
        }
      }
      if (!more) break;
    }
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      if (i0 + q >= n) continue;
      const long long i = row * n + i0 + q;
      if (wq[q] && !top[q] && bot[q]) K[q] = lo[q];
      a.user_w[i] = wpos[q];
      a.user_k[i] = K[q];
    }
    const int au = block_sum(na | (nu << 16), red);
    if (tid == 0) a.tile_au[t] = au;
  }
  grid_sync(a.sync);
  if (stamp) a.trace[2] = global_ns();

  // (c) A_i and u_i; the undecided users compacted with T_i = K_i - A_i
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row = t / NT, tt = t % NT, i0 = tt * TILE + tid * PER;
    if (!__ldcg(a.rowi + row * R_WORDS + R_THR)) continue;
    int pa = 0, pu = 0;
    for (long long k = tid; k < tt; k += THREADS) {
      const int v = __ldcg(a.tile_au + row * NT + k);
      pa += v & 0xffff;
      pu += v >> 16;
    }
    pa = block_sum(pa, red);
    pu = block_sum(pu, red);
    const uint8_t* w = a.waiting + row * n;
    int kq[PER], wp[PER];
    bool wq[PER];
    int na = 0, nu = 0;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const long long i = row * n + i0 + q;
      wq[q] = i0 + q < n && w[i0 + q];
      kq[q] = wq[q] ? __ldcg(a.user_k + i) : -1;
      wp[q] = wq[q] ? __ldcg(a.user_w + i) : 0;
      na += wq[q] && kq[q] >= wp[q];
      nu += wq[q] && kq[q] >= 0 && kq[q] < wp[q];
    }
    int tot;
    const int ex = block_scan(na | (nu << 16), red, &tot);
    int A = pa + (ex & 0xffff), U = pu + (ex >> 16);
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      if (!wq[q]) continue;
      const long long i = row * n + i0 + q;
      a.user_a[i] = A;
      a.user_u[i] = U;
      if (kq[q] >= wp[q]) {
        ++A;
      } else if (kq[q] >= 0) {
        a.list_t[row * n + U] = kq[q] - A;
        ++U;
      }
    }
    if (tid == 0 && tt == NT - 1) {
      a.rowi[row * R_WORDS + R_A] = pa + (tot & 0xffff);
      a.rowi[row * R_WORDS + R_U] = pu + (tot >> 16);
    }
  }
  grid_sync(a.sync);
  if (stamp) a.trace[3] = global_ns();

  // (d) the walk: over the undecided users (threshold rows), or the
  // literal walk over every user (rows that failed the check)
  for (long long row = blockIdx.x; row < B; row += gridDim.x) {
    const int* ri = a.rowi + row * R_WORDS;
    const int W = __ldcg(ri + R_W);
    int* rec = a.rows + row * 4;
    if (__ldcg(ri + R_THR)) {
      const int U = __ldcg(ri + R_U);
      const int* T = a.list_t + row * n;
      int* M = a.list_m + row * (n + 1);
      int m = 0;
      for (int c0 = 0; c0 < U; c0 += CH) {
        const int cnt = min(CH, U - c0), cnt8 = (cnt + 7) / 8 * 8;
        for (int k = tid; k < cnt8; k += THREADS)
          sm.walk.t[k] = k < cnt ? __ldcg(T + c0 + k) : PAD;
        __syncthreads();
        if (tid == 0) m = walk_run(sm.walk.t, sm.walk.m, cnt8 / 8, m);
        __syncthreads();
        for (int k = tid; k < cnt; k += THREADS) M[c0 + k] = sm.walk.m[k];
        __syncthreads();
      }
      if (tid == 0) {
        M[U] = m;
        rec[0] = 1;
        rec[1] = W;
        rec[2] = __ldcg(ri + R_A);
        rec[3] = U;
        atomicAdd(a.sync + 2, 1ull);
      }
    } else if (tid == 0) {
      literal_walk(a, row, a.H[row]);
      rec[0] = 0;
      rec[1] = W;
      rec[2] = rec[3] = -1;
      atomicAdd(a.sync + 3, 1ull);
    }
  }
  grid_sync(a.sync);
  if (stamp) a.trace[4] = global_ns();

  // (e) decisions and operands of the threshold rows
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row = t / NT, i0 = (t % NT) * TILE + tid * PER;
    if (!__ldcg(a.rowi + row * R_WORDS + R_THR)) continue;
    const uint8_t* w = a.waiting + row * n;
    const double* gv = a.gap_vec + row * (n + 1);
    const int* M = a.list_m + row * (n + 1);
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      if (i0 + q >= n) continue;
      const long long i = row * n + i0 + q;
      bool d = false;
      if (w[i0 + q]) {
        const int K = __ldcg(a.user_k + i), wp = __ldcg(a.user_w + i);
        const int u = __ldcg(a.user_u + i);
        const int m0 = K >= 0 ? __ldcg(M + u) : 0;
        d = K >= wp || (K >= 0 && __ldcg(M + u + 1) > m0);
        a.ops[row * n + wp] =
            d ? __ldg(gv + __ldcg(a.user_a + i) + m0) : a.gap_idle[i];
      }
      a.start[i] = (uint8_t)d;
    }
  }
  grid_sync(a.sync);
  if (stamp) a.trace[5] = global_ns();

  // (f) numpy's sum: each block of 8,192 operands pairwise, then the
  // blocks left to right from 0.0 by the row's last block to finish
  for (long long u = blockIdx.x; u < B * NS; u += gridDim.x) {
    const long long row = u / NS, k = u % NS;
    int* ri = a.rowi + row * R_WORDS;
    const long long W = __ldcg(ri + R_W);
    const long long nb = W > 0 ? (W + SUMBLOCK - 1) / SUMBLOCK : 1;
    if (k >= nb) continue;
    const int L = (int)min((long long)SUMBLOCK, W - k * SUMBLOCK);
    const double s = block_pairwise(a.ops + row * n + k * SUMBLOCK, L,
                                    sm.tree, red);
    if (tid == 0) {
      double* part = a.part + row * NS;
      part[k] = s;
      __threadfence();
      if (atomicAdd(ri + R_TICKET, 1) == (int)nb - 1) {
        __threadfence();
        double acc = 0.0;
        for (long long kk = 0; kk < nb; ++kk)
          acc = __dadd_rn(acc, __ldcg(part + kk));
        a.gap_sum[row] = acc;
        if (a.trace) atomicMax(a.trace + 6, global_ns());
      }
    }
    __syncthreads();   // sm.tree is reused by the next unit
  }
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

// the walk's loop as (d) runs it (walk_run over T staged in shared
// memory), over a table of CH entries again and again; m a multiple of 8
__global__ void __launch_bounds__(1)
walk_chain_kernel(long long* out, long long m) {
  __shared__ __align__(16) int s_t[CH], s_m[CH];
  for (int k = 0; k < CH; ++k) s_t[k] = (k * 37) % CH - CH / 4;
  const long long c0 = clock64();
  int x = (int)out[0];
  for (long long done = 0; done < m; done += CH)
    x = walk_run(s_t, s_m, (int)(min((long long)CH, m - done) / 8), x);
  const long long c1 = clock64();
  out[0] = x + s_m[CH - 1];
  out[1] = c1 - c0;
}

// the grid: every block resident (a cooperative launch's rule), at most
// the blocks the SMs hold at once, at most one a tile
cudaError_t grid_blocks(long long work, int* blocks) {
  static int resident = 0;
  if (!resident) {
    int dev, sms, per_sm;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, online_replay_kernel, THREADS, 0);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident = sms * per_sm;
  }
  *blocks = (int)(work < resident ? (work > 0 ? work : 1) : resident);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Bytes of scratch the launch needs for B rows of n users.
long long online_replay_scratch_bytes(long long B, long long n) {
  return (long long)scratch_layout(B, n).bytes;
}

// waiting (B, n) uint8; base, rhs, gap_idle (B, n) f64; gap_vec (B, n + 1)
// f64; H (B,) f64; outputs start (B, n) uint8, gap_sum (B,) f64 and rows
// (B, 4) int32; sync: 4 uint64 words, zero before the first launch, kept
// between launches (the barrier's words return to where they were); scratch
// of online_replay_scratch_bytes(B, n) bytes, 256-byte aligned; trace null
// or 7 uint64 (zero), where the launch writes %globaltimer at its start,
// after each of its five barriers and (the latest) as a row's gap_sum is
// written. All contiguous on one device; one cooperative launch.
int online_replay_launch(const void* waiting, const void* base,
                         const void* rhs, const void* gap_idle,
                         const void* gap_vec, const void* H, void* start,
                         void* gap_sum, void* rows, void* sync, void* scratch,
                         void* trace, long long B, long long n,
                         void* stream) {
  if (B < 1 || n < 0 || n >= 0x7fffffffLL - 1 || B * (n + 1) >= (1LL << 40))
    return (int)cudaErrorInvalidValue;
  const Layout L = scratch_layout(B, n);
  char* s = (char*)scratch;
  Args a;
  a.waiting = (const uint8_t*)waiting;
  a.base = (const double*)base;
  a.rhs = (const double*)rhs;
  a.gap_idle = (const double*)gap_idle;
  a.gap_vec = (const double*)gap_vec;
  a.H = (const double*)H;
  a.start = (uint8_t*)start;
  a.gap_sum = (double*)gap_sum;
  a.rows = (int*)rows;
  a.sync = (unsigned long long*)sync;
  a.trace = (unsigned long long*)trace;
  a.tile_w = (int*)(s + L.off[0]);
  a.tile_v = (int*)(s + L.off[1]);
  a.tile_au = (int*)(s + L.off[2]);
  a.user_w = (int*)(s + L.off[3]);
  a.user_k = (int*)(s + L.off[4]);
  a.user_a = (int*)(s + L.off[5]);
  a.user_u = (int*)(s + L.off[6]);
  a.list_t = (int*)(s + L.off[7]);
  a.list_m = (int*)(s + L.off[8]);
  a.ops = (double*)(s + L.off[9]);
  a.part = (double*)(s + L.off[10]);
  a.rowi = (int*)(s + L.off[11]);
  a.B = B;
  a.n = n;
  a.NT = L.NT;
  a.NS = L.NS;
  int blocks;
  cudaError_t e = grid_blocks(B * (L.NT > 0 ? L.NT : 1), &blocks);
  if (e != cudaSuccess) return (int)e;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)online_replay_kernel,
                                  dim3(blocks), dim3(THREADS), params, 0,
                                  (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// out (2,) f64: out[0] seeds the chain and receives its end, out[1] the
// clock64 cycles the m dependent adds of x took in one thread.
int dadd_chain_launch(void* out, long long m, double x, void* stream) {
  if (m < 0) return (int)cudaErrorInvalidValue;
  dadd_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((double*)out, m, x);
  return (int)cudaGetLastError();
}

// out (2,) int64: out[0] seeds the walk and receives its end, out[1] the
// clock64 cycles the m dependent walk steps took in one thread (m a
// multiple of 8).
int walk_chain_launch(void* out, long long m, void* stream) {
  if (m < 0 || m % 8) return (int)cudaErrorInvalidValue;
  walk_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((long long*)out, m);
  return (int)cudaGetLastError();
}

const char* online_replay_launch_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

const char* dadd_chain_launch_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

const char* walk_chain_launch_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
