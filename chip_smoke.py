"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the K1 and K2
Triton kernels and the K3 and K4 CUDA C++ kernels (an f32 form on the
CUDA cores and a bf16 form on the tensor cores, wgmma fed by TMA, each)
from this checkout and holds each against its plain version (K1, which
applies a chunk of up to 16 pushes in one launch, also against chained
one-push launches bit for bit, and as gap_aware's one-push launches whose
weights are computed on the card); drives the paper's main path
(online-scheduled async LeNet-5 training, one K1 launch a finisher chunk)
on the card, then the paper's other three schedules (immediate, the
offline knapsack oracle, FedAvg sync rounds) with online's energy saving
against each, the online, offline and sync runs again on the CPU (equal
schedule digests, accuracy within 0.03), online under the aggregation
rules gap_aware (one K1 launch a push, beside the same run on the plain
K1), fedasync_poly and hetero_aware (weights through the cohort K1's
weight tensor), and the LeNet backend's run-to-run repeatability (its
im2col-and-matmul convolutions against cuDNN's); the per-user loop oracle
at the main-path setting (LeNet hooks: one client epoch and one one-push
K1 launch a push, held to the batched run's schedule and accuracy), the
MLP backend batched at the main path (K1 at 379,774 parameters, held to a
CPU run), the greedy and eps_greedy schedules (held to their trace-mode
schedules) and Markov device churn under both dropout rules (the numpy
engine against the loop engine); then the device scan engine
(``engine="jax"``): online's in-slot replay (a CUDA C++ kernel, one
launch a slot) bit for bit against its plain version, the paper's
trace-mode experiment at 100,000 users (online, 300 s, at the defaults and
at L_b = 2.0) against the numpy engine on the host, every policy, rule and
the churn rules at the engine matrix's setting, and a 16-point V sweep
run as one batch against its per-point runs; drives the
async federated LM trainer at Qwen3-0.6B's full width (596,049,920
parameters, K2 on every island step, K1 on every push), holds one
full-width train step's K2 epilogue against the plain version and
profiles a few steps; holds K1 on one of the LM's four shards against its
plain version and times it, then runs the trainer's options at full
width: the sharded serving-tier server (four shards, one K1 launch a
shard a push), that server against the unsharded one fed the same pushes
(p' and v' bit for bit), the push ingestion pipeline with each wire codec
(a client dying mid-push and recovering, every push applied exactly
once), compressed pushes (top-k with error feedback, a push timed with
and without it) and checkpoints with a resumed run (restored models bit
for bit); then serves Qwen3-0.6B (attention_impl="flash": K4
on every layer's prefill) and Mamba2-370m (K3 on every layer's prefill)
at full width through ``launch.serve.BatchedServer``, compares each
kernel route's prefill logits with the plain route's, and profiles one
prefill and a few decode steps; then the LM zoo's newer
configurations: K4 at their three new shapes against its plain version,
granite-moe-1b-a400m (the MoE family: sorted dispatch at prefill, the
dense combine at decode) served at full width with K4 and held to the
einsum route (in bf16 at the Qwen3 phase's bound, in f32 token for
token), qwen2.5-3b (with its chunked-attention prefill held to the einsum
route) and phi4-mini-3.8b at full width, and internlm2-20b and
qwen3-moe-30b-a3b at their published widths with their depth cut to fit
the card. The scan phase ends with the padded user axis
(``SimConfig.n_devices``): the fleet run with ``n_devices=1`` and padded
past n, each equal to the plain run bit for bit.

    python3 chip_smoke.py
    python3 chip_smoke.py scan      # the scan-engine phase alone
    python3 chip_smoke.py zoo       # K4's newer shapes and the zoo phase

Needs a CUDA device and the CUDA toolkit (exits non-zero without a
device) and nothing but this repository's ``src/``. Every phase raises on
failure; nothing is caught. The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``,
the line before it the ``{"kernels": [...]}`` record.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# the paper's Fig. 5 setting at LeNet-5's full width (62,006 parameters,
# 32x32x3 inputs, local batch 20, 10,000 training images), 25 clients on
# the Table II devices, half a simulated hour (one hour until the LM
# trainer's options joined the run: cut to fit the time limit)
MAIN = dict(n_users=25, horizon_s=1800, V=5.0, app_arrival_p=0.004, seed=0)
K1_SIZES = (0, 1, 1029, 62006, 2 ** 24 + 17)
K1_COHORT_K = (1, 2, 5, 16)     # pushes a launch: 16 is a full LeNet chunk
K1_WEIGHTS = (1.0, 0.6, 0.05)
K1_BETA_ETA = ((0.9, 0.01), (0.0, 0.5), (0.99, 1e-4))
LENET_N = 62006
MLP_N = 379_774         # models/mlp.py at 32x32x3, hidden (120, 84)
# the JAX package's "churn" fault scenario (tests/test_dynamics_faults.py)
# under both dropout rules, its horizon cut to 900 s of the main path
CHURN = dict(p_off=0.01, p_on=0.05, resume_penalty_s=20.0)
CHURN_HORIZON_S = 900
# greedy and eps_greedy: the main path cut to 900 s (the run's time limit)
GREEDY_HORIZON_S = 900
# the repeatability phase's immediate runs, cut to fit the time limit
REPEAT_HORIZON_S = 600
# the scan engine: the replay kernel's sizes and the paper's trace-mode
# experiment at fleet scale (online, 100,000 users, 300 s), a profiled
# stretch of it, the dependent-add chain that prices its bound, the engine
# matrix's setting (tests/test_engine_matrix.py) and a 16-point V sweep
REPLAY_N = (0, 1, 1029, 100_000)
# the replay's edge cases: an unsorted gap_vec (the literal walk), 16 rows
# of both paths, a row of undecided users, every user waiting at numpy's
# 8,192-operand block edges
REPLAY_EDGES = ("unsorted", "mixed16", "undecided", "w8191", "w8193",
                "w16385")
FLEET_N, FLEET_HORIZON_S, FLEET_PROFILE_S = 100_000, 300, 8
DADD_CHAIN = WALK_CHAIN = 1_000_000
# bytes the replay moves a user: waiting, base, rhs, gap_idle and gap_vec
# read, start written
REPLAY_BYTES_PER_USER = 1 + 8 * 4 + 1
COVER = dict(n_users=10, horizon_s=1500, app_arrival_p=0.01, seed=11,
             V=2000.0, L_b=2.0)
SWEEP_V = tuple(2.5 * (k + 1) for k in range(16))
# Qwen3-0.6B at full width (configs/qwen3_0_6b.py), and its smoke config
QWEN_N = 596_049_920
K2_SIZES = (0, 1, 1029, 82304, QWEN_N, 2 ** 24 + 17)
K2_ETA_BETA = ((0.01, 0.9), (0.05, 0.9), (0.1, 0.0))
# the LM trainer's defaults (4 islands, batch 8, seq 64, 4 local steps),
# 120 scheduler slots with an evaluation every 60
LM_RUN = dict(slots=120, eval_every=60, app_arrival_p=0.05)
# the trainer's options at full width (sharded, compressed, checkpointed):
# 40 slots, ~10 pushes, so that the sharded server's version ring (every
# published version kept, 2.22 GiB each, up to its default depth of 64)
# stays inside the card's 80 GB beside the run's unsharded peak
LM_OPT = dict(slots=40, eval_every=20, app_arrival_p=0.05)
LM_SHARDS = 4
LM_COMPRESS = 0.01
# the compressed and the checkpointed runs: 20 slots (~5 pushes), the
# checkpointed one saving every 10 and at the end
LM_COMPRESS_SLOTS = 20
LM_CKPT_SLOTS = 20
LM_CKPT_EVERY = 10
# (c) and (f): one stream of pulls and pushes (op, client, noise seed);
# client 2's push comes last (it dies mid-push in the ingestion phase)
LM_STREAM = (("pull", 0, 0), ("pull", 1, 0), ("pull", 2, 0),
             ("push", 0, 101), ("pull", 0, 0), ("push", 1, 102),
             ("push", 0, 103), ("push", 2, 104))
# H100 SXM peaks (NVIDIA data sheet): HBM3, bf16 tensor cores, f32 CUDA
# cores
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
# K4: tests/test_kernels.py TestFlashAttention shapes (B, H, KV, S, d), a
# ragged S, and Qwen3-0.6B's serving prefill (batch 8 x 512 tokens)
K4_SHAPES = ((1, 4, 4, 256, 64), (2, 8, 2, 256, 128), (1, 4, 2, 384, 64),
             (1, 2, 1, 512, 32), (2, 4, 2, 200, 64))
K4_SERVE = (8, 16, 8, 512, 128)
# K3: TestSSDScan shapes (B, S, nh, ph, s, chunk); Mamba2-370m's serving
# prefill folds batch 8 x 32 heads into BH = 256 rows of 512 tokens
K3_SHAPES = ((2, 64, 4, 16, 16, 16), (1, 128, 2, 32, 64, 32),
             (2, 96, 3, 8, 24, 32), (1, 64, 8, 64, 128, 16))
K3_SERVE = (8, 512, 32, 64, 128, 256)    # batch, S, heads, ph, s, chunk
# times of the first kernels (f32 products on the CUDA cores) at the
# serving shapes and the prefill times with them, H100 80GB HBM3 at 700 W
# (PERF.md), printed beside this run's
FIRST_FORM_MS = {"K4": 0.492898, "K3": 0.713222}
FIRST_FORM_PREFILL_MS = {"qwen3-0.6b": 48.58, "mamba2-370m": 102.34}
# serving: 8 prompts of 512 tokens, 32 new tokens each, on the card
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 512, 32
# the LM zoo's newer configurations at the serving prefill (batch 8 x
# 512 tokens, bf16), K4's shape (B, H, KV, S, d) for each: granite's head
# dim 64 (16 heads over 8 KV heads), qwen2.5-3b's GQA ratio 8, phi4-mini's
# ratio 3
K4_ZOO = {"granite-moe-1b-a400m": (8, 16, 8, 512, 64),
          "qwen2.5-3b": (8, 16, 2, 512, 128),
          "phi4-mini-3.8b": (8, 24, 8, 512, 128)}
# the two configurations whose f32 weights exceed one card at full depth
# (79.4 and 122.1 GB): layers kept, at their published widths
ZOO_CUT = {"internlm2-20b": 24, "qwen3-moe-30b-a3b": 16}
# chunked attention's q-block for qwen2.5-3b's chunked prefill: two blocks
# of 192 rows and a tail of 128 over 512 tokens (the default 512 would
# leave a 512-token prefill on the einsum route)
ZOO_Q_BLOCK = 192
# the padded user axis: the fleet run padded past n by this many users
PAD_USERS = 8


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def schedule_digest(push_log) -> str:
    payload = json.dumps([(e["t"], e["user"], e["lag"], e["corun"])
                          for e in push_log]).encode()
    return hashlib.sha256(payload).hexdigest()


def k1_inputs(n, seed, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
            .to(device) for _ in range(3)]


def dev_inputs(n, seed):
    """Three f32 standard-normal vectors drawn on the card (host numpy is
    too slow at the LM's 596M elements)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(n, generator=gen, device="cuda") for _ in range(3)]


def max_violation(a, b, rtol, atol):
    """On the card: (max |a - b|, whether every |a - b| <= atol +
    rtol * |b|), numpy's allclose rule."""
    if a.numel() == 0:
        return 0.0, True
    diff = (a - b).abs()
    ok = bool(torch.all(diff <= atol + rtol * b.abs()))
    return float(diff.max()), ok


def time_ms(fn, iters):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters):
    """Device ms a call of ``fn`` (launches only), by CUDA events around
    ``iters`` calls queued behind a sleeping kernel, so that the host's
    cost of each call (binding, allocation) never leaves the card idle
    between them."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)      # ~0.1 s at the card's clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_cohort(out, ref):
    """One K1 result against its plain version at the reference's bounds
    (tests/test_kernels.py): p' at rtol 1e-6 / atol 1e-6; v' at rtol 1e-6
    / atol 1e-6 * (max|v'| + 1), because (cur - mixed) * inv_eta cancels;
    the sums of squares and norms at rtol 1e-5. Returns max |p' - ref|,
    |v' - ref|."""
    (p2, v2, sums, norms), (pr, vr, sr, nr) = (
        [x.cpu().numpy() for x in o] for o in (out, ref))
    np.testing.assert_allclose(p2, pr, rtol=1e-6, atol=1e-6)
    v_scale = float(np.max(np.abs(vr), initial=0.0)) + 1.0
    np.testing.assert_allclose(v2, vr, rtol=1e-6, atol=1e-6 * v_scale)
    np.testing.assert_allclose(sums, sr, rtol=1e-5, atol=1e-10)
    np.testing.assert_allclose(norms, nr, rtol=1e-5, atol=1e-10)
    if p2.size == 0:
        return 0.0
    return max(float(np.max(np.abs(p2 - pr))), float(np.max(np.abs(v2 - vr))))


def chained_single_pushes(fused_apply_cohort, cur, v, trained, w):
    """The k pushes as k one-push K1 launches: (p', v', sums, norms) with
    sums/norms gathered as the k-push launch returns them."""
    p, vv, sums, norms = cur, v, [], []
    for j in range(trained.shape[0]):
        p, vv, s1, n1 = fused_apply_cohort(
            p, vv, trained[j:j + 1], None if w is None else w[j:j + 1],
            100.0, 0.9, kernel="triton")
        sums.append(s1[0])
        norms.append(n1[0])
    return p, vv, torch.stack(sums + [s1[1]]), torch.stack(norms + [n1[1]])


def empty_launch_ms(iters):
    """One launch of an empty Triton kernel (one pointer argument), timed
    like K1: the floor of a Triton launch on this host."""
    import triton
    import triton.language as tl

    @triton.jit
    def empty_kernel(x_ptr):
        if tl.program_id(0) < 0:
            tl.store(x_ptr, 0.0)

    x = torch.zeros(1, device="cuda")
    return time_ms(lambda: empty_kernel[(1,)](x), iters)


def phase_k1(fu, cohort_bytes, ticket_counter):
    """K1 (Triton) against its plain version on the same CUDA tensors: one
    push (``fused_apply_flat``) at every K1_SIZES x weight x (beta, eta),
    then chunks of k in K1_COHORT_K pushes at every size with weights of 1
    (the cached ones) and a mixed weight vector, each also against k
    one-push launches bit for bit (norms included); 100 repeated launches
    give the same bits and leave the ticket counter at 0. Then times by
    CUDA events: a chunk of 1 and of 16 pushes at LeNet's size, one push
    at 2^24+17 and at the LM's size, the plain version beside each, and
    an empty Triton launch."""
    max_err = 0.0
    for n in K1_SIZES:
        cur, v, new = k1_inputs(n, n, "cuda")
        for w in K1_WEIGHTS:
            for beta, eta in K1_BETA_ETA:
                out = fu.fused_apply_flat(cur, v, new, w, 1.0 / eta, beta,
                                          kernel="triton")
                ref = fu.fused_apply_flat(cur, v, new, w, 1.0 / eta, beta,
                                          kernel="reference")
                max_err = max(max_err, check_cohort(out + (out[2],),
                                                    ref + (ref[2],)))
        print(f"K1 n={n}: {len(K1_WEIGHTS) * len(K1_BETA_ETA)} one-push "
              f"cases match the plain version", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(15)
    for n in K1_SIZES:
        cur, v = (torch.randn(n, generator=gen, device="cuda")
                  for _ in range(2))
        trained = torch.randn((max(K1_COHORT_K), n), generator=gen,
                              device="cuda")
        mixed = 0.05 + 0.95 * torch.rand(max(K1_COHORT_K), generator=gen,
                                         device="cuda")
        for k in K1_COHORT_K:
            for w in (None, mixed[:k]):
                args = (cur, v, trained[:k].contiguous(), w, 100.0, 0.9)
                out = fu.fused_apply_cohort(*args, kernel="triton")
                ref = fu.fused_apply_cohort(*args, kernel="reference")
                max_err = max(max_err, check_cohort(out, ref))
                single = chained_single_pushes(fu.fused_apply_cohort,
                                               *args[:4])
                assert all(torch.equal(a, b) for a, b in zip(out, single)), \
                    (n, k, w is None)
        print(f"K1 n={n}: chunks of {K1_COHORT_K} pushes, weights 1 and "
              f"mixed, match the plain version and equal as many one-push "
              f"launches bit for bit, norms included", flush=True)
        del cur, v, trained
    for n, k in ((LENET_N, 16), (2 ** 24 + 17, 1)):
        cur, v = (torch.randn(n, generator=gen, device="cuda")
                  for _ in range(2))
        trained = torch.randn((k, n), generator=gen, device="cuda")
        w = 0.05 + 0.95 * torch.rand(k, generator=gen, device="cuda")
        first = fu.fused_apply_cohort(cur, v, trained, w, 100.0, 0.9,
                                      kernel="triton")
        for _ in range(100):
            again = fu.fused_apply_cohort(cur, v, trained, w, 100.0, 0.9,
                                          kernel="triton")
            assert all(torch.equal(a, b) for a, b in zip(first, again)), n
        torch.cuda.synchronize()
        assert int(ticket_counter("cuda")) == 0
        print(f"K1 n={n} k={k}: 100 repeated launches give the same bits; "
              f"the ticket counter is back at 0", flush=True)
    torch.cuda.empty_cache()
    times = {}
    for n, k, iters in ((LENET_N, 1, 2000), (LENET_N, 16, 2000),
                        (2 ** 24 + 17, 1, 100), (QWEN_N, 1, 20)):
        cur, v = (torch.randn(n, generator=gen, device="cuda")
                  for _ in range(2))
        trained = torch.randn((k, n), generator=gen, device="cuda")
        args = (cur, v, trained, None, 100.0, 0.9)
        ms = time_ms(lambda: fu.fused_apply_cohort(*args, kernel="triton"),
                     iters)
        plain = time_ms(lambda: fu.fused_apply_cohort(
            *args, kernel="reference"), max(iters // 10, 5))
        bound = cohort_bytes(n, k) / HBM_BPS * 1e3
        times[n, k] = (ms, plain, bound)
        print(f"K1 n={n} k={k}: kernel {ms:.6f} ms a launch "
              f"({ms / k:.6f} ms a push), plain {plain:.6f} ms, bound "
              f"{bound:.6f} ms ({cohort_bytes(n, k)} B at 3.35 TB/s; "
              f"{bound / ms:.1%} of it)", flush=True)
        del cur, v, trained, args
        torch.cuda.empty_cache()
    times["empty"] = empty_launch_ms(5000)
    print(f"K1: an empty Triton launch (one pointer argument) "
          f"{times['empty']:.6f} ms, timed the same way", flush=True)
    # gap_aware: a chunk's pushes as one-push launches, each weight
    # computed on the card from the previous launch's norm
    from repro_torch.core.aggregation import GapAwareRule
    from repro_torch.core.realml import gap_aware_pushes
    k = 16
    cur, v = (torch.randn(LENET_N, generator=gen, device="cuda")
              for _ in range(2))
    trained = torch.randn((k, LENET_N), generator=gen, device="cuda")
    args = (cur, v, trained, np.arange(k) % 4 + 1,
            torch.linalg.vector_norm(v).reshape(1), GapAwareRule(0.5), None,
            np.arange(k), 0.01, 0.9, 100.0)
    out = gap_aware_pushes(*args, "triton")
    ref = gap_aware_pushes(*args, "reference")
    max_err = max(max_err, check_cohort(
        (out[0], out[1], out[2] ** 2, out[2]),
        (ref[0], ref[1], ref[2] ** 2, ref[2])))
    np.testing.assert_allclose(out[3].cpu().numpy(), ref[3].cpu().numpy(),
                               rtol=1e-6)
    assert float(out[3].min()) < 1.0
    ms = time_ms(lambda: gap_aware_pushes(*args, "triton"), 200) / k
    plain = time_ms(lambda: gap_aware_pushes(*args, "reference"), 20) / k
    times["gap_aware"] = (ms, plain)
    print(f"K1 gap_aware, {k} one-push launches at n={LENET_N} with the "
          f"weights computed on the card: match the plain chain (weights at "
          f"rtol 1e-6); {ms:.6f} ms a push (weight + launch), plain "
          f"{plain:.6f} ms", flush=True)
    return max_err, times


def phase_k2(fused_update_flat, bound_ms):
    """K2 (Triton) against its plain version on the same CUDA tensors, at
    the reference's bounds (tests/test_kernels.py): theta' and v' at rtol
    1e-6 / atol 1e-6, Sum(v'^2) at rtol 1e-5. Then times at the LM's full
    width and at 2^24+17: the kernel, the plain version, the bound, and
    for scale torch's fused SGD step with momentum followed by a vector
    norm (two calls; no single PyTorch call computes K2's function)."""
    max_err = 0.0
    for n in K2_SIZES:
        theta, v, g = dev_inputs(n, n)
        for eta, beta in K2_ETA_BETA:
            out = fused_update_flat(theta, v, g, eta, beta, kernel="triton")
            ref = fused_update_flat(theta, v, g, eta, beta,
                                    kernel="reference")
            for name, a, b in zip(("theta'", "v'"), out[:2], ref[:2]):
                assert n == 0 or a.data_ptr() not in (
                    theta.data_ptr(), v.data_ptr(), g.data_ptr())
                err, ok = max_violation(a, b, 1e-6, 1e-6)
                assert ok, (n, eta, beta, name, err)
                max_err = max(max_err, err)
            np.testing.assert_allclose(float(out[2]), float(ref[2]),
                                       rtol=1e-5, atol=1e-10)
            del out, ref
        print(f"K2 n={n}: {len(K2_ETA_BETA)} cases match the plain version "
              f"(rtol 1e-6, atol 1e-6; sum of squares rtol 1e-5)",
              flush=True)
        del theta, v, g
        torch.cuda.empty_cache()
    times = {}
    for n in (QWEN_N, 2 ** 24 + 17):
        theta, v, g = dev_inputs(n, 1)
        iters = 20 if n == QWEN_N else 100
        ms = time_ms(lambda: fused_update_flat(theta, v, g, 0.05, 0.9,
                                               kernel="triton"), iters)
        plain = time_ms(lambda: fused_update_flat(theta, v, g, 0.05, 0.9,
                                                  kernel="reference"), iters)
        sgd_ms = None
        if "fused" in inspect.signature(torch.optim.SGD).parameters:
            p = torch.nn.Parameter(theta.clone())
            p.grad = g
            opt = torch.optim.SGD([p], lr=0.05, momentum=0.9, dampening=0.9,
                                  fused=True)

            def sgd():
                opt.step()
                torch.linalg.vector_norm(opt.state[p]["momentum_buffer"])

            sgd_ms = time_ms(sgd, iters)
            del p, opt
        times[n] = (ms, plain, bound_ms(n), sgd_ms)
        print(f"K2 n={n}: kernel {ms:.6f} ms, plain {plain:.6f} ms, bound "
              f"{bound_ms(n):.6f} ms (20 B/element at 3.35 TB/s), torch "
              f"SGD(fused=True).step + vector_norm (two calls) "
              f"{sgd_ms if sgd_ms is None else f'{sgd_ms:.6f}'} ms",
              flush=True)
        del theta, v, g
        torch.cuda.empty_cache()
    return max_err, times


def _timed(fn, name, stats):
    """``fn`` wrapped to count its calls and their host seconds into
    ``stats[name]``."""
    stats[name] = [0, 0.0]

    def timed(*a, **k):
        t = time.perf_counter()
        out = fn(*a, **k)
        stats[name][0] += 1
        stats[name][1] += time.perf_counter() - t
        return out

    timed.__wrapped__ = fn
    return timed


def _time_calls(obj, name, stats):
    """Replace ``obj.name`` with ``_timed`` of it."""
    setattr(obj, name, _timed(getattr(obj, name), name, stats))


def run_main(Scenario, policy, device, counter, aggregation="replace",
             kernel="auto", label="", ml="lenet", engine="auto", chunk=None,
             **over):
    """One run of the main path (``MAIN``, with ``over`` replacing its
    entries) with the ``ml`` backend on ``engine``, finisher chunks of at
    most ``chunk`` lanes (the backend's ``COHORT_CHUNK`` unless given);
    returns (result, wall_s, launches, pushes, chunks, stats, the
    simulator).
    Prints the host seconds spent in the backend's entry points: the
    cohort finish (local epochs + K1 pushes; ``local_train_batch`` under
    sync), the evaluation, and ``v_norm``, the host sync the online policy
    makes every slot that has waiting users; and, inside the finish, in
    the K1 wrapper calls (the push side: one a chunk of at most
    COHORT_CHUNK finishers, one a push under gap_aware) and, under
    gap_aware, in ``gap_aware_pushes`` (the weights computed on the card,
    then the one-push launches)."""
    from repro_torch.core import realml
    sim = Scenario(policy=policy, ml=ml, engine=engine,
                   aggregation=aggregation, kernel=kernel,
                   ml_kwargs=dict(device=device),
                   **dict(MAIN, **over)).build()
    backend = sim.ml_backend
    if chunk is not None:
        backend.COHORT_CHUNK = chunk
        label += f", chunks of {chunk}"
    entry = "local_train_batch" if backend.sync else "finish_async_batch"
    stats = {}
    for name in (entry, "evaluate", "v_norm"):
        _time_calls(backend, name, stats)
    for name in ("fused_apply_cohort", "gap_aware_pushes"):
        _time_calls(realml, name, stats)
    train = getattr(backend, entry)
    chunks = [0]

    def counted(uids, *a, **k):
        chunks[0] += -(-len(uids) // backend.COHORT_CHUNK)
        return train(uids, *a, **k)

    setattr(backend, entry, counted)
    if device == "cuda":
        torch.cuda.synchronize()
    counter.launches = counter.pushes = 0
    t0 = time.perf_counter()
    try:
        res = sim.run()
    finally:
        for name in ("fused_apply_cohort", "gap_aware_pushes"):
            setattr(realml, name, getattr(realml, name).__wrapped__)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, pushes = counter.launches, counter.pushes
    label = (f"{policy} ({ml}, {aggregation}, kernel={kernel}, "
             f"engine {sim.resolve_engine()}{label}"
             + "".join(f", {k}={v}" for k, v in over.items()
                       if isinstance(v, (int, float, str))) + ")")
    print(f"{label} on {device}: energy {res.energy_j!r} J, updates "
          f"{res.updates}, pushes {len(res.push_log)}, finisher chunks "
          f"{chunks[0]}, K1 launches {launches} applying {pushes} pushes, "
          f"co-run fraction {res.corun_fraction!r}, mean_H {res.mean_H!r}, "
          f"schedule digest {schedule_digest(res.push_log)[:16]}, "
          f"accuracy {res.accuracy}, wall {wall!r} s, "
          f"{res.updates / wall!r} updates/s; host seconds (calls): "
          + ", ".join(f"{k} {v[1]!r} ({v[0]})" for k, v in stats.items())
          + " (fused_apply_cohort: the K1 wrapper calls)", flush=True)
    assert np.isfinite(res.energy_j) and res.energy_j > 0
    assert all(0.0 <= a <= 1.0 for _, a in res.accuracy)
    return res, wall, launches, pushes, chunks[0], stats, sim


def phase_schedules(Scenario, counter, online):
    """The paper's other three schedules at the main-path setting on the
    card (Figs. 4-6 compare online against them): immediate and offline
    push through K1 (launches = finisher chunks, pushes = updates), sync
    averages FedAvg rounds (one a closed round, the model moved from its
    initial parameters) and launches no K1. How far sync's accuracy
    climbs depends on the initial parameters (the JAX package's own sync
    at this setting ends at chance for some seeds), so the card's sync is
    held to the CPU run's in ``phase_cpu`` and to the JAX package's, on
    the same initial parameters, by tests/test_torch_sync.py. Prints each
    schedule's energy, updates, co-run fraction, final accuracy and K1
    launches, and online's energy saving against each. Returns {policy:
    result}."""
    runs = {"online": online}
    for policy in ("immediate", "offline", "sync"):
        res, _, launches, pushes, chunks, _, sim = run_main(
            Scenario, policy, "cuda", counter)
        assert res.updates > 0, policy
        if policy == "sync":
            # FedAvg: no K1; every closed round averaged its models into
            # a new global model
            assert launches == pushes == 0, "sync launched K1"
            b = sim.ml_backend
            p0 = b.model_init(torch.Generator().manual_seed(MAIN["seed"]),
                              device="cuda")
            moved = float((b.server.params - p0).abs().max())
            print(f"sync: {b.server.round} rounds averaged (version "
                  f"{sim.state.version}); the global model moved "
                  f"{moved!r} (max abs) from its initial parameters",
                  flush=True)
            assert b.server.round == sim.state.version > 1
            assert moved > 0.0, "sync rounds left the model as it was"
        else:
            assert launches == chunks, (policy, launches, chunks)
            assert pushes == len(res.push_log) == res.updates, policy
        runs[policy] = res
    for policy, res in runs.items():
        print(f"schedule {policy}: energy {res.energy_j!r} J, updates "
              f"{res.updates}, co-run fraction {res.corun_fraction!r}, "
              f"final accuracy {res.accuracy[-1][1]!r}", flush=True)
    for policy in ("immediate", "offline", "sync"):
        print(f"online vs {policy}: energy saving "
              f"{1.0 - online.energy_j / runs[policy].energy_j!r}",
              flush=True)
    return runs


@contextlib.contextmanager
def card_conv_route():
    """LeNet's convolutions as the card computes them (im2col + matmul,
    ``lenet.conv_im2col``) on every device for the block."""
    from repro_torch.models import lenet
    saved = lenet._conv
    lenet._conv = lenet.conv_im2col
    try:
        yield
    finally:
        lenet._conv = saved


def phase_cpu(Scenario, counter, card):
    """The online, offline and sync runs again on the CPU (the plain K1,
    the card's convolution route, im2col + matmul, on the CPU's BLAS):
    while mean_H == 0 the schedule digest must equal the card's and
    accuracy agree within 0.03 at every sample (the bound of
    tests/test_real_mode.py). Both sides take one algorithm, so what parts
    them is the two libraries' rounding; with ``F.conv2d`` on the CPU,
    offline's last sample lands 0.031 from the card's after an hour (a
    near-zero ReLU pre-activation taken to the other side)."""
    for policy in ("online", "offline", "sync"):
        with card_conv_route():
            cpu, _, launches, pushes, _, _, _ = run_main(
                Scenario, policy, "cpu", counter)
        assert launches == pushes == 0, "a CPU run launched K1"
        gpu = card[policy]
        if gpu.mean_H == 0.0 and cpu.mean_H == 0.0:
            assert schedule_digest(cpu.push_log) == \
                schedule_digest(gpu.push_log), f"{policy}: schedules differ"
            assert [s for s, _ in cpu.accuracy] == \
                [s for s, _ in gpu.accuracy]
            gap = float(np.max(np.abs(
                np.array([a for _, a in gpu.accuracy])
                - np.array([a for _, a in cpu.accuracy]))))
            assert gap <= 0.03, f"{policy}: accuracy {gap} apart"
            print(f"CPU {policy} run: same schedule digest "
                  f"{schedule_digest(gpu.push_log)[:16]}, accuracy at most "
                  f"{gap!r} apart", flush=True)
        else:
            print(f"CPU {policy} run: mean_H {cpu.mean_H!r} / "
                  f"{gpu.mean_H!r} > 0, schedules may part ways; digest not "
                  "compared", flush=True)


def phase_rules(Scenario, counter, online):
    """The aggregation rules beyond replace, online on the card. gap_aware
    (the main-path setting): one one-push K1 launch a push, each weight
    computed on the card from the previous launch's norm, so launches =
    pushes = updates; the schedule equals the replace run's while mean_H
    == 0; every logged weight is the rule's of its own pre-push norm
    (rtol 1e-6); the same run with the plain K1 (kernel="reference", on
    the card) takes the same pushes with the same weights (rtol 1e-6)
    until rounding in the sums of squares parts the two trajectories,
    and its accuracy stays within 0.03 (the bound of
    tests/test_real_mode.py for two f32 runs of a schedule). fedasync_poly and
    hetero_aware (horizon cut to 900 s): the weights, known before a
    chunk, go through the cohort K1's weight tensor, so launches =
    finisher chunks. Returns (gap_aware launches, host ms a push)."""
    res, wall, launches, pushes, chunks, stats, _ = run_main(
        Scenario, "online", "cuda", counter, aggregation="gap_aware")
    assert launches == pushes == len(res.push_log) == res.updates, \
        (launches, pushes, res.updates)
    if res.mean_H == 0.0 and online.mean_H == 0.0:
        assert schedule_digest(res.push_log) == \
            schedule_digest(online.push_log), "gap_aware schedule differs"
    ref, ref_wall, ref_launches, _, _, ref_stats, _ = run_main(
        Scenario, "online", "cuda", counter, aggregation="gap_aware",
        kernel="reference")
    assert ref_launches == 0
    assert schedule_digest(ref.push_log) == schedule_digest(res.push_log)
    gap_ref = 1.0       # GapAwareRule's default
    (w, g), (w_ref, g_ref) = (
        (np.array([e["weight"] for e in r.push_log]),
         np.array([e["gap"] for e in r.push_log])) for r in (res, ref))
    for ww, gg in ((w, g), (w_ref, g_ref)):
        # each weight is the rule's of its own pre-push norm (f32 on the
        # card against the f64 gap logged from the same norm)
        np.testing.assert_allclose(ww, 1.0 / (1.0 + gg / gap_ref),
                                   rtol=1e-6)
    assert w.min() < 1.0 and np.all((0.0 < w) & (w <= 1.0))
    # the two runs take the same pushes with the same weights until K1's
    # sums of squares (another order than torch.sum's, rtol 1e-5) have
    # moved a weight, and with it the model, far enough to part them
    parted = ~np.isclose(g, g_ref, rtol=1e-5, atol=1e-9)
    prefix = int(np.argmax(parted)) if parted.any() else len(g)
    np.testing.assert_allclose(w[:prefix], w_ref[:prefix], rtol=1e-6)
    assert prefix > int(np.argmax(w < 1.0)), \
        "the K1 and plain runs part before their first weight below 1"
    acc_gap = float(np.max(np.abs(np.array([a for _, a in res.accuracy])
                                  - np.array([a for _, a in ref.accuracy]))))
    push_ms = stats["gap_aware_pushes"][1] / max(pushes, 1) * 1e3
    ref_push_ms = ref_stats["gap_aware_pushes"][1] / max(pushes, 1) * 1e3
    print(f"gap_aware, K1 against the plain K1 on the card: every weight is "
          f"the rule's of its own gap (rtol 1e-6); the runs' weights agree "
          f"(rtol 1e-6) over their first {prefix} of {len(w)} pushes, until "
          f"rounding parts them (max weight difference over the run "
          f"{float(np.max(np.abs(w - w_ref)))!r}, min weight {w.min()!r}); "
          f"accuracy at most {acc_gap!r} apart; walls {wall!r} s (K1) and "
          f"{ref_wall!r} s (plain); the push side {push_ms!r} ms a push (K1) "
          f"and {ref_push_ms!r} ms (plain) of host time", flush=True)
    assert acc_gap <= 0.03, acc_gap
    for rule in ("fedasync_poly", "hetero_aware"):
        r, _, n_launch, n_push, n_chunks, _, _ = run_main(
            Scenario, "online", "cuda", counter, aggregation=rule,
            horizon_s=900)
        assert n_launch == n_chunks and n_push == r.updates > 0, rule
        wr = np.array([e["weight"] for e in r.push_log])
        assert wr.min() < 1.0, rule
    return launches, push_ms


CONV_ROUTES = ("im2col + matmul (the model's)", "cuDNN, default algorithms",
               "cuDNN, deterministic algorithms")


def cudnn_conv(x, w, b):
    """LeNet's convolution through cuDNN (``F.conv2d``), for comparison."""
    return torch.nn.functional.conv2d(x, w.permute(3, 2, 0, 1), b)


@contextlib.contextmanager
def conv_route(i):
    """Run LeNet on the card through ``CONV_ROUTES[i]`` for the block; the
    model's convolution and cuDNN's flags are restored after it."""
    from repro_torch.models import lenet
    cudnn = torch.backends.cudnn
    saved = lenet._conv, cudnn.deterministic, cudnn.benchmark
    if i:
        lenet._conv = cudnn_conv
        cudnn.deterministic, cudnn.benchmark = i == 2, False
    try:
        yield
    finally:
        lenet._conv, cudnn.deterministic, cudnn.benchmark = saved


def phase_repeat(Scenario, counter):
    """Run-to-run repeatability of the LeNet backend on the card, and how
    close each way of computing its convolutions stays to the CPU. One
    16-lane chunk of the main path's local epoch on the CPU (the card's
    route), then on the card three times through each of ``CONV_ROUTES``: are the three equal
    bit for bit, how far are they from the CPU's (max and mean |diff|), and
    what does an epoch take (CUDA events)? A profile of one epoch names the
    convolution kernels of the cuDNN routes. Then the immediate schedule,
    its horizon cut to ``REPEAT_HORIZON_S``, twice through the model's
    route (equal push logs and accuracy) and twice through cuDNN's
    default algorithms (the spread, and the wall of each)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.realml import LeNetBackend, _masked_epoch
    lanes = min(16, MAIN["n_users"])

    def chunk(device):
        b = LeNetBackend(MAIN["n_users"], seed=0, device=device)
        b.pull_batch(np.arange(lanes), 0)
        params, idx, mask = next(b._cohort_chunks(np.arange(lanes)))
        return lambda: _masked_epoch(params, idx, mask, b._flat_x,
                                     b._flat_y, b.eta, b.beta, b.model_loss)

    with card_conv_route():
        ref = chunk("cpu")()
    epoch = chunk("cuda")
    for i, name in enumerate(CONV_ROUTES):
        with conv_route(i):
            outs = [epoch() for _ in range(3)]
            ms = time_ms(epoch, 5)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                epoch()
                torch.cuda.synchronize()
        same = all(torch.equal(outs[0], o) for o in outs[1:])
        spread = max(float((outs[0] - o).abs().max()) for o in outs[1:])
        d = (outs[0].cpu() - ref).abs()
        rows = sorted(((e.key, e.self_device_time_total, e.count)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA),
                      key=lambda r: -r[1])
        conv = [r for r in rows if any(w in r[0].lower() for w in (
            "conv", "wgrad", "dgrad", "winograd", "implicit", "gemm"))]
        print(f"repeat, one epoch of {lanes} lanes, {name}: three runs "
              f"{'equal bit for bit' if same else 'DIFFER'} (max |diff| "
              f"{spread!r}); against the CPU's epoch max |diff| "
              f"{float(d.max())!r}, mean {float(d.mean())!r}; {ms!r} ms an "
              f"epoch", flush=True)
        for key, us, count in conv[:5]:
            print(f"repeat:   {us * 1e-3:9.3f} ms {count:5d}x  {key[:100]}",
                  flush=True)
        if i == 0:
            assert same, "the model's epochs differ between runs"
    for i in (0, 1):
        with conv_route(i):
            runs = [run_main(Scenario, "immediate", "cuda", counter,
                             label="" if i == 0 else f", {CONV_ROUTES[i]}",
                             horizon_s=REPEAT_HORIZON_S)
                    for _ in range(2)]
        (r1, w1, *_), (r2, w2, *_) = runs
        same = list(r1.push_log) == list(r2.push_log) and \
            r1.accuracy == r2.accuracy
        print(f"repeat, immediate {REPEAT_HORIZON_S} s twice, "
              f"{CONV_ROUTES[i]}: "
              f"{'equal' if same else 'DIFFER'}; accuracy {r1.accuracy} / "
              f"{r2.accuracy}; walls {w1!r} / {w2!r} s", flush=True)
        if i == 0:
            assert same, "two card runs of the model's route differ"


def accuracy_gap(a, b):
    """Max |accuracy a - accuracy b| over two runs' samples, which must be
    taken at the same slots."""
    assert [s for s, _ in a.accuracy] == [s for s, _ in b.accuracy]
    return float(np.max(np.abs(np.array([x for _, x in a.accuracy])
                               - np.array([x for _, x in b.accuracy]))))


def phase_loop(Scenario, make_ml_hooks, counter, online):
    """The per-user loop oracle at the main-path setting (Fig. 5's oracle):
    ``make_ml_hooks`` LeNet hooks on the card, one client epoch
    (``Client.local_train``) and one ``AsyncParameterServer.push`` — one
    one-push K1 launch — a finisher. K1 launches = pushes = updates, and
    while mean_H == 0 the schedule digest equals the batched online run's.

    A client's epoch on the card equals the batched engine's epoch of a
    one-lane chunk bit for bit, but a lane of a 16-lane chunk lands ~1 ulp
    from it (cuBLAS sums a batch of 16 in another order), and over an
    hour the two f32 trajectories part. So the loop is held to the batched
    engine run with chunks of one lane: the same push log (gaps
    included), the same accuracy at every sample and the same final model,
    bit for bit. Its accuracy distance to the default batched run (chunks
    of up to 16) is printed. Prints the wall, updates/s and the host
    seconds in the hooks (``v_norm`` reads the host float the last push
    left: no device sync). Returns (launches, result)."""
    from repro_torch.core.realml import LeNetBackend, _masked_epoch
    b = LeNetBackend(MAIN["n_users"], seed=MAIN["seed"], device="cuda")
    lanes = np.arange(min(16, MAIN["n_users"]))
    b.pull_batch(lanes, 0)
    perms, draw = {}, b._next_perm
    b._next_perm = lambda uid: perms.setdefault(uid, draw(uid))
    wide = _masked_epoch(*next(b._cohort_chunks(lanes)), b._flat_x,
                         b._flat_y, b.eta, b.beta, b.model_loss)
    lane_ulps = []
    for j in (0, len(lanes) - 1):
        one = _masked_epoch(*next(b._cohort_chunks(lanes[j:j + 1])),
                            b._flat_x, b._flat_y, b.eta, b.beta,
                            b.model_loss)[0]
        own = b.clients[j].local_train(b.server.params)[0]
        assert torch.equal(own, one), "a client epoch != its one-lane chunk"
        lane_ulps.append(float((wide[j] - one).abs().max()))
    print(f"loop oracle: a client's epoch equals the batched engine's "
          f"one-lane chunk bit for bit (lanes 0 and {len(lanes) - 1}); the "
          f"same lanes of a {len(lanes)}-lane chunk are max |diff| "
          f"{lane_ulps} from it", flush=True)
    del b, wide
    hooks, state = make_ml_hooks(MAIN["n_users"], seed=MAIN["seed"],
                                 device="cuda")
    stats = {}
    for name in ("local_train", "push", "pull", "evaluate", "v_norm"):
        hooks[name] = _timed(hooks[name], name, stats)
    torch.cuda.synchronize()
    counter.launches = counter.pushes = 0
    t0 = time.perf_counter()
    res = Scenario(policy="online", engine="loop", ml_mode="real",
                   **MAIN).run(ml_hooks=hooks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, pushes = counter.launches, counter.pushes
    print(f"loop oracle, online (lenet hooks) on cuda: energy "
          f"{res.energy_j!r} J, updates {res.updates}, K1 launches "
          f"{launches} applying {pushes} pushes, schedule digest "
          f"{schedule_digest(res.push_log)[:16]}, mean_H {res.mean_H!r}, "
          f"accuracy {res.accuracy}, wall {wall!r} s, "
          f"{res.updates / wall!r} updates/s; host seconds (calls): "
          + ", ".join(f"{k} {v[1]!r} ({v[0]})" for k, v in stats.items()),
          flush=True)
    assert launches == pushes == len(res.push_log) == res.updates > 0, \
        (launches, pushes, res.updates)
    one, _, one_launches, _, one_chunks, _, sim = run_main(
        Scenario, "online", "cuda", counter, chunk=1)
    assert one_launches == one_chunks == one.updates
    assert list(res.push_log) == list(one.push_log), \
        "loop and one-lane batched push logs differ"
    assert res.accuracy == one.accuracy
    assert torch.equal(state["server"].params,
                       sim.ml_backend.server.params)
    if res.mean_H == 0.0 and online.mean_H == 0.0:
        assert schedule_digest(res.push_log) == \
            schedule_digest(online.push_log), "loop schedule differs"
        gap = accuracy_gap(res, online)
        print(f"loop oracle: the batched run with one-lane chunks gives the "
              f"same push log, accuracy and final model bit for bit; the "
              f"default batched run (chunks of up to 16) the same schedule "
              f"digest, accuracy at most {gap!r} apart", flush=True)
    else:
        print("loop oracle: the one-lane batched run is equal bit for bit; "
              "mean_H > 0, so the default batched run's digest is not "
              "compared", flush=True)
    return launches, res


def phase_mlp(Scenario, fu, cohort_bytes, counter):
    """The MLP backend (``ml="mlp"``, 379,774 parameters) batched, online
    at the main-path setting on the card: K1 launches = finisher chunks,
    pushes = updates. K1 at n = 379,774 for a chunk of 1 and of 16 pushes
    against its plain version (the K1 bounds) and timed by CUDA events
    beside the plain version and the bound (((2+k)*4+8)*n bytes at 3.35
    TB/s). Then the same run on the CPU (the plain K1): the schedule digest
    equal while mean_H == 0, accuracy within 0.03 at every sample. Returns
    (launches, chunks, max_err, {k: (ms, plain_ms, bound_ms)})."""
    res, wall, launches, pushes, chunks, _, _ = run_main(
        Scenario, "online", "cuda", counter, ml="mlp")
    assert launches == chunks > 0, (launches, chunks)
    assert pushes == len(res.push_log) == res.updates, (pushes, res.updates)
    gen = torch.Generator(device="cuda").manual_seed(21)
    max_err, times = 0.0, {}
    for k in (1, 16):
        cur, v = (torch.randn(MLP_N, generator=gen, device="cuda")
                  for _ in range(2))
        trained = torch.randn((k, MLP_N), generator=gen, device="cuda")
        args = (cur, v, trained, None, 100.0, 0.9)
        out = fu.fused_apply_cohort(*args, kernel="triton")
        ref = fu.fused_apply_cohort(*args, kernel="reference")
        max_err = max(max_err, check_cohort(out, ref))
        ms = time_ms(lambda: fu.fused_apply_cohort(*args, kernel="triton"),
                     2000)
        plain = time_ms(lambda: fu.fused_apply_cohort(
            *args, kernel="reference"), 200)
        bound = cohort_bytes(MLP_N, k) / HBM_BPS * 1e3
        times[k] = (ms, plain, bound)
        print(f"K1 n={MLP_N} (the MLP) k={k}: matches the plain version; "
              f"kernel {ms:.6f} ms a launch, plain {plain:.6f} ms, bound "
              f"{bound:.6f} ms ({cohort_bytes(MLP_N, k)} B at 3.35 TB/s; "
              f"{bound / ms:.1%} of it)", flush=True)
    cpu, *_ = run_main(Scenario, "online", "cpu", counter, ml="mlp")
    if res.mean_H == 0.0 and cpu.mean_H == 0.0:
        assert schedule_digest(cpu.push_log) == \
            schedule_digest(res.push_log), "MLP: card and CPU schedules differ"
        gap = accuracy_gap(cpu, res)
        print(f"CPU MLP run: same schedule digest "
              f"{schedule_digest(res.push_log)[:16]}, accuracy at most "
              f"{gap!r} apart", flush=True)
        assert gap <= 0.03, gap
    else:
        print(f"CPU MLP run: mean_H {cpu.mean_H!r} / {res.mean_H!r} > 0; "
              "digest not compared", flush=True)
    return launches, chunks, max_err, times


def phase_greedy(Scenario, counter):
    """greedy and eps_greedy with LeNet on the card at the main-path
    setting, the horizon cut to ``GREEDY_HORIZON_S``: neither reads the
    momentum norm, so each real-mode schedule digest must equal the same
    seed's trace-mode run on the host; K1 launches = finisher chunks,
    pushes = updates. Prints each one's energy against online's over the
    same horizon (its trace run: while H == 0 online's real-mode schedule
    and energy are its trace run's, as the CPU phase and the loop phase
    show at the full horizon)."""
    cut = dict(MAIN, horizon_s=GREEDY_HORIZON_S)
    online = Scenario(policy="online", **cut).run()
    for policy in ("greedy", "eps_greedy"):
        res, _, launches, pushes, chunks, _, _ = run_main(
            Scenario, policy, "cuda", counter,
            label=f", horizon cut to {GREEDY_HORIZON_S} s",
            horizon_s=GREEDY_HORIZON_S)
        trace = Scenario(policy=policy, **cut).run()
        assert res.updates == trace.updates > 0, policy
        assert schedule_digest(res.push_log) == \
            schedule_digest(trace.push_log), f"{policy}: real != trace"
        assert res.energy_j == trace.energy_j, policy
        assert launches == chunks and pushes == res.updates, policy
        print(f"{policy}: real-mode schedule digest "
              f"{schedule_digest(res.push_log)[:16]} equals the trace "
              f"run's; energy {res.energy_j!r} J against online's "
              f"{online.energy_j!r} J (online saves "
              f"{1.0 - online.energy_j / res.energy_j!r}), updates "
              f"{res.updates} against {online.updates}, horizon cut to "
              f"{GREEDY_HORIZON_S} s", flush=True)


def phase_churn(Scenario, counter):
    """Markov device churn (the JAX package's "churn" knobs) with LeNet on
    the card, online, the horizon cut to ``CHURN_HORIZON_S``: under each
    dropout rule the numpy engine (batched) and the loop engine (the
    backend's per-user hooks) take the same schedule — digest of (t,
    user, lag, corun); the gaps carry each engine's norms — and count the
    same mid-training drops, more than none."""
    from repro_torch.core import MarkovChurnDynamics
    for dropout in ("lose", "resume"):
        runs = {}
        for engine in ("vectorized", "loop"):
            dyn = MarkovChurnDynamics(dropout=dropout, **CHURN)
            runs[engine] = run_main(
                Scenario, "online", "cuda", counter, engine=engine,
                label=f", markov churn {CHURN}, dropout={dropout}, horizon "
                f"cut to {CHURN_HORIZON_S} s", dynamics=dyn,
                horizon_s=CHURN_HORIZON_S)
        (vec, _, vl, vp, vc, _, _), (loop, _, ll, lp, _, _, _) = \
            runs["vectorized"], runs["loop"]
        assert vec.drops == loop.drops > 0, (vec.drops, loop.drops)
        assert vec.updates == loop.updates > 0
        assert schedule_digest(vec.push_log) == \
            schedule_digest(loop.push_log), f"churn {dropout}: engines differ"
        assert vl == vc and ll == lp == loop.updates
        print(f"churn ({dropout}, horizon cut to {CHURN_HORIZON_S} s): "
              f"numpy and loop engines take the same schedule "
              f"{schedule_digest(vec.push_log)[:16]}, {vec.drops} drops, "
              f"{vec.updates} updates; K1 {vl} launches (numpy engine), "
              f"{ll} (loop)", flush=True)


# ---------------------------------------------------------------------------
# The scan engine (engine="jax"): online's in-slot replay kernel, the
# paper's trace-mode experiment at fleet scale, coverage and a batched sweep
# ---------------------------------------------------------------------------
def replay_inputs(B, n, H, seed):
    """Online's replay operands on the card, (B, n) rows built as the
    engine builds them (V P t_d - Q, V P t_d, idle gaps + eps, Eq. 4 gaps at
    in_flight + 0..n) from Table II-like powers, with ties on purpose: a
    third of the users have base == rhs and an idle gap equal to an entry
    of gap_vec, so b + H g_j == r + H g_i where the walk reaches j = i, and
    a tenth sit one ulp either side of rhs."""
    rng = np.random.default_rng(seed)
    waiting = rng.random((B, n)) < 0.7
    powers = np.array([0.3, 0.55, 1.2, 2.4, 3.1])
    V, Q = 4000.0, rng.integers(0, 50, (B, 1)).astype(float)
    rhs = V * rng.choice(powers, (B, n)) * 1.0
    base = V * rng.choice(powers, (B, n)) * 1.0 - Q
    in_flight = rng.integers(0, 20, (B, 1))
    lag = (in_flight + np.arange(n + 1)).astype(float)
    vn = 1.0 / np.sqrt(1.0 + 0.05 * rng.integers(0, 500, (B, 1)))
    gap_vec = 0.01 * (1.0 - np.power(0.9, lag)) / (1.0 - 0.9) * vn
    gap_idle = rng.choice([0.05, 0.1, 0.15, 0.5], (B, n))
    tie = rng.random((B, n)) < 1 / 3
    base = np.where(tie, rhs, base)
    k = rng.integers(0, n + 1, (B, n)) if n else np.zeros((B, 0), int)
    gap_idle = np.where(tie, np.take_along_axis(gap_vec, k, 1), gap_idle)
    ulp = rng.random((B, n)) < 0.1
    base = np.where(ulp, np.nextafter(rhs, rng.choice([-np.inf, np.inf],
                                                      (B, n))), base)
    Hs = np.full(B, float(H))
    cuda = lambda a, dt: torch.as_tensor(a).to("cuda", dt)
    return (cuda(waiting, torch.bool), cuda(base, torch.float64),
            cuda(rhs, torch.float64), cuda(gap_idle, torch.float64),
            cuda(gap_vec, torch.float64), cuda(Hs, torch.float64))


def replay_edge_inputs(kind):
    """The replay's edge rows (REPLAY_EDGES) on the card: ``unsorted`` a
    row whose gap_vec descends (the literal walk); ``mixed16`` 16 rows,
    row 0 descending, row 1 ascending, the rest either at random;
    ``undecided`` base == rhs and g_i = gap_vec[k_i] for k_i < w_i on a
    strictly increasing gap_vec, every user waiting, so that all but the
    first are undecided; ``wN`` every one of N users waiting."""
    rng = np.random.default_rng(len(kind))
    if kind == "undecided":
        n = 3000
        gv = 1e-3 * (3.0 + np.arange(n + 1))[None]
        k = rng.integers(0, np.maximum(np.arange(n), 1))
        r = np.full((1, n), 4000.0)
        args = (np.ones((1, n), bool), r.copy(), r, gv[:, k], gv,
                np.full(1, 1.0))
    else:
        B, n = ((1, 2000) if kind == "unsorted" else (16, 1500)
                if kind == "mixed16" else (1, int(kind[1:])))
        w, b, r, gi, gv, H = (t.cpu().numpy() for t in
                              replay_inputs(B, n, 37.5, seed=n + B))
        if kind[0] == "w":
            w = np.ones_like(w)
        else:
            gv = np.tile(1e-3 * (3.0 + np.arange(n + 1)), (B, 1))
            k = rng.integers(0, n + 1, (B, n))
            gi = np.where(b == r, np.take_along_axis(gv, k, 1), gi)
            flip = np.ones(B, bool) if kind == "unsorted" else \
                rng.random(B) < 0.5
            flip[:2] = (True, False)[:B]
            gv = np.where(flip[:, None], gv[:, ::-1], gv)
        args = (w, b, r, gi, gv, H)
    dt = (torch.bool,) + (torch.float64,) * 5
    return tuple(torch.as_tensor(np.ascontiguousarray(a)).to("cuda", d)
                 for a, d in zip(args, dt))


def sum_depth(W):
    """Dependent f64 adds on the longest chain of numpy's sum of W
    operands (blocks of 8,192 added in order to 0.0, each block
    pairwise: leaves of <= 128 by eight strided accumulators, or serially
    from 0.0 below 8)."""
    def pairwise(n):
        if n < 8:
            return n
        if n <= 128:
            return max(n // 8 - 1, 0) + 3 + n % 8
        n2 = n // 2 - (n // 2) % 8
        return max(pairwise(n2), pairwise(n - n2)) + 1
    depth = 0
    for lo in range(0, W, 8192):
        depth = max(depth, pairwise(min(8192, W - lo))) + 1
    return depth


def phase_replay(replay):
    """(a) online's replay kernel against its plain version on the same
    CUDA tensors, bit for bit (start and gap_sum), at n in REPLAY_N, B in
    (1, 16), H = 0 and H > 0, and at REPLAY_EDGES; each launch's per-row
    record (path, waiting, always, undecided) against the host's
    classification of the same inputs (``online_replay_rows_ref``), and
    the per-device path counters.
    Then at the main path's shape (n = FLEET_N, H > 0, B = 1 and 16): ms
    a launch (``device_ms``), the plain version's ms, and the bound, the
    larger of the bytes (REPLAY_BYTES_PER_USER a user at HBM_BPS) and the
    serial chain that remains: the undecided users of the fullest row,
    one dependent walk step each (``walk_chain_cuda``: WALK_CHAIN steps in
    one thread, by CUDA events), then ``sum_depth`` dependent f64 adds
    (``dadd_chain_cuda``). The earlier kernel's bound (one dependent f64
    add a waiting user) is printed beside it, and the us each phase of
    one traced launch took (``phase_ns``). Returns a dict for the kernels
    record and the counts of the timed row."""
    online_replay, online_replay_cuda = (replay.online_replay,
                                         replay.online_replay_cuda)
    cases, max_err, literal_rows = 0, 0.0, 0

    def check(args, label):
        nonlocal cases, max_err, literal_rows
        replay.reset_path_rows()
        ks, kg = online_replay(*args, kernel="cuda")
        rows = online_replay_cuda.last_rows.cpu().numpy()
        ps, pg = online_replay(*args, kernel="reference")
        torch.cuda.synchronize()
        max_err = max(max_err, float((kg - pg).abs().max())
                      if kg.numel() else 0.0)
        assert torch.equal(ks, ps), (label, "start")
        assert torch.equal(kg.view(torch.int64), pg.view(torch.int64)), \
            (label, "sum")
        want = replay.online_replay_rows_ref(*args).numpy()
        assert np.array_equal(rows, want), (label, rows, want)
        lit = int((want[:, 0] == 0).sum())
        assert replay.path_rows() == (len(want) - lit, lit), label
        literal_rows += lit
        cases += 1
        return want

    for n in REPLAY_N:
        for B in (1, 16):
            for H in (0.0, 37.5):
                check(replay_inputs(B, n, H, seed=n + B), (n, B, H))
    for kind in REPLAY_EDGES:
        want = check(replay_edge_inputs(kind), kind)
        if kind == "unsorted":
            assert want[0, 0] == 0, kind
        if kind == "mixed16":
            assert (want[0, 0], want[1, 0]) == (0, 1), kind
        if kind == "undecided":
            assert want[0, 3] == want[0, 1] - 1, kind
    print(f"replay: kernel equals its plain version bit for bit (start, "
          f"gap_sum) in {cases} cases: n in {REPLAY_N}, B in (1, 16), H = 0 "
          f"and 37.5, with ties, and {REPLAY_EDGES}; every row's path and "
          f"counts as the host classifies them ({literal_rows} rows took "
          f"the literal walk)", flush=True)
    chain = replay.dadd_chain_cuda(DADD_CHAIN)
    walk = replay.walk_chain_cuda(WALK_CHAIN)
    torch.cuda.synchronize()
    dadd_ms = time_ms(lambda: replay.dadd_chain_cuda(DADD_CHAIN), 5)
    walk_ms = time_ms(lambda: replay.walk_chain_cuda(WALK_CHAIN), 5)
    dadd_ns, walk_ns = dadd_ms * 1e6 / DADD_CHAIN, walk_ms * 1e6 / WALK_CHAIN
    print(f"replay yardsticks: one dependent DADD {dadd_ns:.3f} ns "
          f"({float(chain[1]) / DADD_CHAIN:.2f} cycles), one walk step "
          f"{walk_ns:.3f} ns ({int(walk[1]) / WALK_CHAIN:.2f} cycles), each "
          f"over a chain of {DADD_CHAIN} in one thread ({dadd_ms:.6f} / "
          f"{walk_ms:.6f} ms)", flush=True)
    out = {}
    for B in (1, 16):
        args = replay_inputs(B, FLEET_N, 37.5, seed=7)
        ms = device_ms(lambda: online_replay_cuda(*args), 50)
        rows = replay.online_replay_rows_ref(*args).numpy()
        assert np.array_equal(online_replay_cuda.last_rows.cpu().numpy(),
                              rows)
        t0 = time.perf_counter()
        online_replay(*args, kernel="reference")
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1e3
        phases = replay.phase_ns(*args)
        W, U = int(rows[:, 1].max()), int(rows[:, 3].max())
        bytes_ms = (REPLAY_BYTES_PER_USER * FLEET_N + 16) * B / HBM_BPS * 1e3
        depth = sum_depth(W)
        ops_ms = (U * walk_ns + depth * dadd_ns) * 1e-6
        old_ms = W * dadd_ns * 1e-6
        bound = max(bytes_ms, ops_ms)
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        A = int(rows[0, 2])
        print(f"replay at B={B}, n={FLEET_N}, H > 0: kernel {ms:.6f} ms a "
              f"launch, plain {plain:.3f} ms; bound {bound:.6f} ms by {by} "
              f"({bound / ms:.1%}): {U} undecided users (fullest row) x "
              f"{walk_ns:.3f} ns + {depth} dependent adds of the gap sum x "
              f"{dadd_ns:.3f} ns = {ops_ms:.6f} ms, bytes "
              f"{REPLAY_BYTES_PER_USER} a user = {bytes_ms:.6f} ms; the "
              f"serial-DADD bound of the earlier kernel ({W} waiting users "
              f"x one dependent add) {old_ms:.6f} ms; row 0: {W} waiting, "
              f"{A} always, {W - A - int(rows[0, 3])} never, "
              f"{int(rows[0, 3])} undecided; one traced launch, us a "
              f"phase: " + ", ".join(f"{k} {v / 1e3:.1f}"
                                     for k, v in phases.items()), flush=True)
        out[B] = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                      serial_dadd_ms=old_ms, waiting=W, always=A,
                      undecided=U, phase_us={k: v / 1e3
                                             for k, v in phases.items()})
    return dict(out[1], cases=cases, max_abs_err=max_err, b16=out[16])


def check_scan(ref, res, label):
    """The scan engine's run against the numpy engine's (the reference's
    engine-parity contract, tests/test_engine_matrix.py): schedule digest
    (t, user, lag, corun) equal, energy and mean_Q within rel 1e-9, mean_H
    within rel 1e-6, gap and weight within rtol 1e-9 / atol 1e-15."""
    assert res.updates == ref.updates, (label, res.updates, ref.updates)
    assert schedule_digest(res.push_log) == schedule_digest(ref.push_log), \
        label
    assert res.drops == ref.drops, label
    np.testing.assert_allclose(res.energy_j, ref.energy_j, rtol=1e-9,
                               err_msg=label)
    np.testing.assert_allclose(res.mean_Q, ref.mean_Q, rtol=1e-9, atol=1e-12,
                               err_msg=label)
    np.testing.assert_allclose(res.mean_H, ref.mean_H, rtol=1e-6, atol=1e-9,
                               err_msg=label)
    for col in ("gap", "weight"):
        np.testing.assert_allclose(res.push_log.field(col),
                                   ref.push_log.field(col), rtol=1e-9,
                                   atol=1e-15, err_msg=f"{label}: {col}")


def profile_kernels(build):
    """The run of a sim that ``build()`` makes, once unprofiled, timed to
    a synchronize (the wall: the profiler's own host cost would inflate
    it), then, on a second build, under torch.profiler: (device kernel
    launches, device busy s, unprofiled wall s, profiled wall s, the
    replay kernel's device s). One stream, so busy time is the sum of
    kernel self times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sim = build()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sim = build()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) * 1e-6
    replay = sum(e.self_device_time_total for e in rows
                 if "online_replay" in e.key) * 1e-6
    return sum(e.count for e in rows), busy, wall, prof_wall, replay


def phase_fleet(Scenario, replay):
    """(b) online at FLEET_N users for FLEET_HORIZON_S, push log on,
    jax_chunk=0 (auto-tuned), once at the defaults and once at L_b = 2.0
    (H > 0: the replay's order matters), each held to the numpy engine on
    the host (``check_scan``); every slot's replay took the threshold path
    (the kernel's per-device path counters). Prints simulated slots/s and
    user-slots/s, peak memory, the tuned chunk, capacity and budget,
    overflow retries, and two profiles at L_b = 2.0: the first
    FLEET_PROFILE_S slots and the whole FLEET_HORIZON_S (kernels a slot,
    device busy, idle share, the replay's device seconds). Returns the
    replay launches of the L_b = 2.0 run (one a slot) and that run's
    (result, sim, Scenario kwargs)."""
    online_replay_cuda = replay.online_replay_cuda
    launches = last = None
    for over in ({}, {"L_b": 2.0}):
        kw = dict(policy="online", n_users=FLEET_N,
                  horizon_s=FLEET_HORIZON_S, seed=0, **over)
        sim = Scenario(engine="jax", jax_chunk=0, **kw).build(device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        online_replay_cuda.launches = 0
        replay.reset_path_rows()
        t0 = time.perf_counter()
        res = sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = online_replay_cuda.launches
        paths = replay.path_rows()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        t0 = time.perf_counter()
        ref = Scenario(engine="vectorized", **kw).run()
        ref_wall = time.perf_counter() - t0
        label = f"online at {FLEET_N} users, {over or 'defaults'}"
        check_scan(ref, res, label)
        T = FLEET_HORIZON_S
        info = sim.scan_info
        assert launches == T, (launches, T)
        assert paths == (T, 0), (label, "rows by path", paths)
        if over:
            assert res.mean_H > 0, "the L_b=2.0 run never had H > 0"
            last = (res, sim, kw)
        print(f"scan: {label}, {T} slots: wall {wall!r} s, "
              f"{T / wall!r} slots/s, {FLEET_N * T / wall!r} user-slots/s, "
              f"peak {peak!r} GiB; jax_chunk=0 tuned to {info.chunk} slots, "
              f"push capacity {info.capacity} (tuned "
              f"{info.tune.push_capacity}), budget {info.tune.device_budget} "
              f"B, modeled {info.tune.est_bytes_per_device} B, "
              f"{info.retries} overflow retries; {res.updates} updates, "
              f"mean_H {res.mean_H!r} (the numpy engine's "
              f"{ref.mean_H!r}), energy {res.energy_j!r} J; replay "
              f"launches {launches}, rows by path (threshold, literal) "
              f"{paths}; the numpy engine on the host took "
              f"{ref_wall!r} s ({T / ref_wall!r} slots/s), same schedule "
              f"{schedule_digest(res.push_log)[:16]}", flush=True)
    for slots in (FLEET_PROFILE_S, FLEET_HORIZON_S):
        prof = Scenario(policy="online", engine="jax", n_users=FLEET_N,
                        horizon_s=slots, L_b=2.0, seed=0)
        n_k, busy, wall, prof_wall, replay_s = profile_kernels(
            lambda: prof.build(device="cuda"))
        print(f"scan: profile of a {slots}-slot online run at {FLEET_N} "
              f"users, L_b=2.0: {n_k} device kernels ({n_k / slots!r} a "
              f"slot), wall {wall!r} s (unprofiled; {prof_wall!r} s "
              f"profiled), device busy {busy!r} s (idle share "
              f"{1.0 - busy / wall!r} of the unprofiled wall), of which the "
              f"replay {replay_s!r} s ({replay_s / busy:.1%} of busy)",
              flush=True)
    return launches, last


def assert_same_run(ref, rsim, res, sim, label):
    """Two scan runs of one configuration equal bit for bit: the push log,
    the Q/H/energy traces, every per-user field and carry leaf of the
    final state, the rng key."""
    assert list(res.push_log) == list(ref.push_log), label
    for f in ("energy_j", "updates", "mean_Q", "mean_H", "drops"):
        assert getattr(res, f) == getattr(ref, f), (label, f)
    for f in ("trace_t", "trace_Q", "trace_H", "trace_energy"):
        assert np.array_equal(getattr(res, f), getattr(ref, f)), (label, f)
    for f in ("mode", "cooldown", "app", "app_rem", "train_rem", "corun",
              "idle_gap", "pulled_at", "energy", "updates", "plan",
              "rng_key"):
        assert np.array_equal(getattr(sim.state, f),
                              getattr(rsim.state, f)), (label, f)


def phase_n_devices(Scenario, fleet):
    """(e) the padded user axis at fleet scale: the L_b = 2.0 fleet run of
    (b) again with ``n_devices=1`` (one card: the user axis is not padded)
    and padded past n by PAD_USERS inert users (the scan engine's internal
    ``n_arr``), each equal to (b)'s run bit for bit (``assert_same_run``);
    ``autotune_scan_params(sim, n_devices=1)`` equal to the single-device
    call."""
    from repro_torch.core import autotune, vector_engine
    ref, rsim, kw = fleet
    tuned = autotune.autotune_scan_params(rsim, n_devices=1)
    assert vars(tuned) == vars(autotune.autotune_scan_params(rsim)), tuned
    runs = {}
    for label, n_arr, over in (("n_devices=1", 0, {"n_devices": 1}),
                               (f"padded to n_arr {FLEET_N + PAD_USERS}",
                                FLEET_N + PAD_USERS, {})):
        sim = Scenario(engine="jax", jax_chunk=0, **kw, **over).build(
            device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if n_arr:
            res = vector_engine._Scan([sim], torch.device("cuda"),
                                      n_arr=n_arr).run()[0]
        else:
            assert sim.resolve_engine() == "jax"
            res = sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert sim.scan_info.n_arr == (n_arr or FLEET_N), sim.scan_info
        assert_same_run(ref, rsim, res, sim, label)
        runs[label] = wall
        print(f"scan (e) online at {FLEET_N} users, L_b=2.0, {label}: wall "
              f"{wall!r} s; push log ({len(res.push_log)} pushes), trace_Q, "
              f"trace_H, trace_energy, {res.updates} updates, energy "
              f"{res.energy_j!r} J and every per-user field equal to (b)'s "
              f"run bit for bit; autotune at n_devices=1 = single device "
              f"(chunk {tuned.jax_chunk}, capacity {tuned.push_capacity})",
              flush=True)
    return runs


def phase_coverage(Scenario):
    """(c) the six policies under replace, online and eps_greedy under the
    other three rules, and Markov churn under both dropout rules, at
    tests/test_engine_matrix.py's setting (COVER), each on the card's scan
    engine against the numpy engine (``check_scan``)."""
    from repro_torch.core import MarkovChurnDynamics
    from repro_torch.core.policies import registered_policies
    runs = [(p, "replace", "none") for p in registered_policies()]
    runs += [(p, r, "none") for p in ("online", "eps_greedy")
             for r in ("fedasync_poly", "gap_aware", "hetero_aware")]
    runs += [("online", "replace", d) for d in ("lose", "resume")]
    t0 = time.perf_counter()
    for policy, rule, dropout in runs:
        kw = dict(COVER, policy=policy, aggregation=rule)
        if dropout != "none":
            kw["dynamics"] = MarkovChurnDynamics(dropout=dropout, **CHURN)
        res = Scenario(engine="jax", **kw).run(device="cuda")
        ref = Scenario(engine="vectorized", **kw).run()
        check_scan(ref, res, f"{policy}/{rule}/{dropout}")
        if dropout != "none":
            assert res.drops > 0
    print(f"scan: {len(runs)} runs (6 policies x replace, online and "
          f"eps_greedy x 3 rules, churn lose/resume) at {COVER} equal the "
          f"numpy engine; {time.perf_counter() - t0:.1f} s", flush=True)


def phase_sweep(Scenario, run_sweep):
    """(d) a 16-point V sweep of online as one batch on the card, each row
    against its own per-point scan run (digest equal, energies rel 1e-9),
    the batch's wall against the 16 per-point walls; then a sweep with
    push_log_capacity=1, which must overflow and re-run, losslessly."""
    base = Scenario(policy="online", n_users=25, horizon_s=600, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = base.sweep(V=SWEEP_V, device="cuda")
    torch.cuda.synchronize()
    batch_wall = time.perf_counter() - t0
    walls = []
    for sc, r in zip(base.grid(V=SWEEP_V), rows):
        t0 = time.perf_counter()
        pp = Scenario(config=dataclasses.replace(sc.config, engine="jax")
                      ).run(device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        assert schedule_digest(r.push_log) == schedule_digest(pp.push_log)
        assert r.updates == pp.updates
        np.testing.assert_allclose(r.energy_j, pp.energy_j, rtol=1e-9)
        np.testing.assert_allclose(r.trace_energy, pp.trace_energy,
                                   rtol=1e-9)
    print(f"sweep: {len(SWEEP_V)} V points as one batch on the card "
          f"{batch_wall!r} s, the same points one by one {sum(walls)!r} s "
          f"(each {min(walls)!r}-{max(walls)!r} s); every row equals its "
          f"per-point run; updates {[r.updates for r in rows]}", flush=True)
    grid = Scenario(policy="immediate", n_users=25, horizon_s=600, seed=1,
                    push_log_capacity=1).grid(seed=[1, 2, 3, 4])
    sims = [sc.build(device="cuda") for sc in grid]
    from repro_torch.core import run_jax_sweep
    res = run_jax_sweep(sims)
    for sc, sim, r in zip(grid, sims, res):
        ref = Scenario(config=dataclasses.replace(
            sc.config, engine="vectorized")).run()
        check_scan(ref, r, f"overflow sweep seed {sc.config.seed}")
    retries = sims[0].scan_info.retries
    assert retries > 0, "push_log_capacity=1 never overflowed"
    print(f"sweep with push_log_capacity=1: {retries} overflow retries, "
          f"capacity grew to {sims[0].scan_info.capacity}, pushes "
          f"{[len(r.push_log) for r in res]} equal the numpy engine's",
          flush=True)


def phase_scan(Scenario, run_sweep, replay):
    """The scan-engine phase: (a) the replay kernel, (b) fleet scale,
    (c) coverage, (d) a batched sweep, (e) the padded user axis. Returns
    the replay's kernel-record numbers."""
    t = time.perf_counter()
    rec = phase_replay(replay)
    print(f"scan phase (a) replay: {time.perf_counter() - t:.1f} s",
          flush=True)
    t = time.perf_counter()
    launches, fleet = phase_fleet(Scenario, replay)
    print(f"scan phase (b) fleet: {time.perf_counter() - t:.1f} s",
          flush=True)
    t = time.perf_counter()
    phase_coverage(Scenario)
    print(f"scan phase (c) coverage: {time.perf_counter() - t:.1f} s",
          flush=True)
    t = time.perf_counter()
    phase_sweep(Scenario, run_sweep)
    print(f"scan phase (d) sweep: {time.perf_counter() - t:.1f} s",
          flush=True)
    t = time.perf_counter()
    phase_n_devices(Scenario, fleet)
    print(f"scan phase (e) n_devices: {time.perf_counter() - t:.1f} s",
          flush=True)
    return dict(rec, launches=launches)


def profile_main(Scenario, horizon_s):
    """torch.profiler over a shortened online run on the card: device busy
    time (the sum of kernel self times; one stream, so no overlap) against
    the host wall time, and the kernels that take the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sim = Scenario(policy="online", ml="lenet", ml_kwargs=dict(device="cuda"),
                   **dict(MAIN, horizon_s=horizon_s)).build()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernel rows only (a CPU operator's row repeats its kernels' time)
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_s = sum(r[1] for r in rows) * 1e-6
    n_kernels = sum(r[2] for r in rows)
    k1 = [(us, count) for key, us, count in rows
          if "fused_apply_cohort" in key]
    copies = sum(count for key, _, count in rows if "DtoH" in key)
    print(f"profile: online, horizon {horizon_s} s, {res.updates} updates, "
          f"wall {wall!r} s (profiled), device busy {busy_s!r} s, idle "
          f"share {1.0 - busy_s / wall!r}, device-side kernel launches "
          f"{n_kernels} ({n_kernels / max(res.updates, 1)!r} per update); "
          f"K1 {sum(c for _, c in k1)} launches, "
          f"{sum(u for u, _ in k1) / max(sum(c for _, c in k1), 1)!r} us of "
          f"device time each; {copies} device-to-host copies", flush=True)
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"profile:   {us * 1e-3:10.3f} ms  {count:7d}x  {key[:90]}",
              flush=True)


def run_lm(train, AsyncParameterServer, k1, k2):
    """The LM path on the card: the async federated trainer at Qwen3-0.6B's
    full width (``LM_RUN``). Counts K1/K2 launches over exactly this run,
    the pushes and local epochs (with their host seconds: a push's
    ``float`` of the new momentum norm is the run's per-push host sync,
    and it waits for the island's queued epoch), the wall time and the
    peak memory."""
    out, stats, k1_launches, steps, wall, _ = run_trainer(
        train, k1, k2, "unsharded",
        timers=((AsyncParameterServer, "push"),), **LM_RUN)
    icfg = train.IslandConfig(**dict(LM_OPT, **LM_RUN))
    pushes, push_s = stats["push"]
    train_s = push_s + stats["local_epoch"][1]
    print(f"LM qwen3-0.6b ({QWEN_N} parameters, batch {icfg.batch}, seq "
          f"{icfg.seq}, {icfg.local_steps} local steps): pushes {pushes} "
          f"({pushes} host syncs, one per push), steps {steps}; energy "
          f"{out['energy_j']!r} J; {steps / train_s!r} steps/s and "
          f"{steps * icfg.batch * icfg.seq / train_s!r} tokens/s over the "
          f"host seconds in local_epoch and push, {steps / wall!r} steps/s "
          f"over the wall (setup included)", flush=True)
    assert out["updates"] == pushes > 0, (out["updates"], pushes)
    assert k1_launches == pushes == k1.pushes, (k1_launches, pushes,
                                                k1.pushes)
    return out["params"], (k1_launches, steps)


def lm_batch(cfg, seed):
    from repro_torch.data.synthetic import synthetic_tokens, token_batches
    stream = synthetic_tokens(20_000, cfg.vocab_size, seed=seed)
    batch = next(token_batches(stream, 8, 64, 1, seed=seed))
    return {k: torch.from_numpy(x).cuda() for k, x in batch.items()}


def phase_lm_step(params, cfg, make_train_step, k2):
    """One full-width train step on the same inputs with kernel="reference"
    and kernel="auto": theta', v' at K2's bound (rtol 1e-6 / atol 1e-6),
    the gap at rtol 1e-5 (the sum-of-squares bound)."""
    from repro_torch.kernels.fused_update.ops import tree_leaves, tree_map
    gen = torch.Generator(device="cuda").manual_seed(5)
    v = tree_map(lambda p: 0.01 * torch.randn(p.shape, generator=gen,
                                              device="cuda"), params)
    batch = lm_batch(cfg, seed=11)
    p_ref, v_ref, m_ref = make_train_step(cfg, eta=0.05, beta=0.9,
                                          kernel="reference")(
        params, v, batch, 3)
    k2.launches = 0
    p_k, v_k, m_k = make_train_step(cfg, eta=0.05, beta=0.9)(
        params, v, batch, 3)
    assert k2.launches == 1, k2.launches
    max_err = 0.0
    for a, b in zip(tree_leaves(p_k) + tree_leaves(v_k),
                    tree_leaves(p_ref) + tree_leaves(v_ref)):
        err, ok = max_violation(a, b, 1e-6, 1e-6)
        assert ok, err
        max_err = max(max_err, err)
    np.testing.assert_allclose(float(m_k["gap"]), float(m_ref["gap"]),
                               rtol=1e-5)
    assert np.isfinite(float(m_k["loss"]))
    print(f"LM step: theta', v' of {QWEN_N} parameters match the plain K2 "
          f"at rtol 1e-6 / atol 1e-6 (max abs err {max_err!r}); gap "
          f"{float(m_k['gap'])!r} vs {float(m_ref['gap'])!r}; loss "
          f"{float(m_k['loss'])!r} vs {float(m_ref['loss'])!r}", flush=True)
    return max_err


def profile_lm_steps(params, cfg, make_train_step, n_steps=3):
    """torch.profiler over a few full-width train steps (K2 on each):
    device busy time against the wall, the kernels that take the most of
    it, and the flatten/concat the tree wrappers pay per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.fused_update.ops import (flatten_concat,
                                                      tree_map)
    concat_ms = time_ms(lambda: flatten_concat(params), 5)
    print(f"LM flatten+concat of one {QWEN_N}-parameter tree: "
          f"{concat_ms:.6f} ms (the K2 and K1 tree wrappers do three per "
          f"call)", flush=True)
    step = make_train_step(cfg, eta=0.05, beta=0.9)
    batch = lm_batch(cfg, seed=12)
    v = tree_map(torch.zeros_like, params)
    p, v, _ = step(params, v, batch, 1)         # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            p, v, _ = step(p, v, batch, 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_s = sum(r[1] for r in rows) * 1e-6
    print(f"LM profile: {n_steps} steps, wall {wall!r} s (profiled), "
          f"{wall / n_steps * 1e3!r} ms/step, device busy {busy_s!r} s, "
          f"idle share {1.0 - busy_s / wall!r}, device-side kernel launches "
          f"{sum(r[2] for r in rows)}", flush=True)
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:12]:
        print(f"LM profile:   {us * 1e-3:10.3f} ms  {count:6d}x  "
              f"{key[:90]}", flush=True)


def live_gib(label) -> float:
    """Collect garbage, then print and return the device memory that live
    tensors hold, in GiB."""
    gc.collect()
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated() / 2 ** 30
    print(f"device memory before {label}: {live!r} GiB allocated", flush=True)
    return live


def peak_gib(reset=False) -> float:
    """Peak device memory since the last reset, in GiB."""
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if reset:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    return peak


def run_trainer(train, k1, k2, label, timers=(), **over):
    """One run of the LM trainer at Qwen3-0.6B's full width with
    ``LM_OPT`` (``over`` replacing or adding options): counts the K1/K2
    launches of exactly this run and the calls of ``timers`` (``(obj,
    name)`` pairs) with their host seconds; prints the wall, the peak
    memory and the losses. Returns (out, stats, k1 launches, k2 launches,
    wall, peak GiB)."""
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-0.6b")
    assert cfg.param_count() == QWEN_N, cfg.param_count()
    icfg = train.IslandConfig(**dict(LM_OPT, **over))
    stats = {}
    originals = {(obj, name): getattr(obj, name)
                 for obj, name in ((train.Island, "local_epoch"),) + timers}
    for obj, name in originals:
        _time_calls(obj, name, stats)
    peak_gib(reset=True)
    k1.launches = k1.pushes = k2.launches = 0
    t0 = time.perf_counter()
    try:
        out = train.run(cfg, icfg, device="cuda",
                        log=lambda m: print(f"LM {label}: {m}", flush=True))
        torch.cuda.synchronize()
    finally:
        for (obj, name), fn in originals.items():
            setattr(obj, name, fn)
    wall = time.perf_counter() - t0
    peak = peak_gib()
    launches = (k1.launches, k2.launches)
    losses = [l for _, l, _ in out["history"]] + [out["final_loss"]]
    epochs = stats["local_epoch"][0]
    print(f"LM {label} (qwen3-0.6b, {icfg.n_islands} islands, "
          f"{icfg.slots} slots): updates {out['updates']}, local epochs "
          f"{epochs}, K1 launches {launches[0]} ({k1.pushes} pushes), K2 "
          f"launches {launches[1]}; eval loss first {losses[0]!r} last "
          f"{losses[-1]!r}; wall {wall!r} s; host seconds (calls) "
          + ", ".join(f"{k} {v[1]!r} ({v[0]})" for k, v in stats.items())
          + f"; peak memory {peak!r} GiB", flush=True)
    assert all(np.isfinite(l) for l in losses), losses
    assert launches[1] == icfg.local_steps * epochs, (launches[1], epochs)
    assert peak * 2 ** 30 < torch.cuda.get_device_properties(0).total_memory
    return out, stats, launches[0], launches[1], wall, peak


def phase_k1_shard(fu, cohort_bytes):
    """K1 on one shard of the sharded LM server (Qwen3-0.6B in 4 shards:
    149,012,480 elements, one push) against its plain version on the same
    CUDA tensors (p' and v' at the reference's bound, the sum of squares
    at rtol 1e-5), then timed: kernel, plain version, bound."""
    n = QWEN_N // LM_SHARDS
    cur, v, new = dev_inputs(n, 21)
    out = fu.fused_apply_flat(cur, v, new, 0.6, 100.0, 0.9, kernel="triton")
    ref = fu.fused_apply_flat(cur, v, new, 0.6, 100.0, 0.9,
                              kernel="reference")
    err_p, ok_p = max_violation(out[0], ref[0], 1e-6, 1e-6)
    v_scale = float(ref[1].abs().max()) + 1.0
    err_v, ok_v = max_violation(out[1], ref[1], 1e-6, 1e-6 * v_scale)
    assert ok_p and ok_v, (err_p, err_v)
    np.testing.assert_allclose(float(out[2]), float(ref[2]), rtol=1e-5)
    del out, ref
    ms = time_ms(lambda: fu.fused_apply_flat(cur, v, new, 1.0, 100.0, 0.9,
                                             kernel="triton"), 50)
    plain = time_ms(lambda: fu.fused_apply_flat(
        cur, v, new, 1.0, 100.0, 0.9, kernel="reference"), 10)
    bound = cohort_bytes(n, 1) / HBM_BPS * 1e3
    print(f"K1 on one LM shard (n={n}, k=1): matches the plain version "
          f"(max abs err p' {err_p!r}, v' {err_v!r}); kernel {ms:.6f} ms, "
          f"plain {plain:.6f} ms, bound {bound:.6f} ms "
          f"({cohort_bytes(n, 1)} B at 3.35 TB/s; {bound / ms:.1%} of it)",
          flush=True)
    del cur, v, new
    torch.cuda.empty_cache()
    return ms, plain, bound, max(err_p, err_v)


def lm_stream_new(flat, seed):
    """A pushed model: ``flat`` moved by 1e-3-scaled noise drawn on the
    card from ``seed``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return flat + 1e-3 * torch.randn(flat.numel(), generator=gen,
                                     device="cuda")


def phase_sharded_server(AsyncParameterServer, ShardedAsyncParameterServer,
                         params, k1):
    """The sharded server (4 shards) against the unsharded
    ``AsyncParameterServer`` at full width, fed the same pushes
    (``LM_STREAM``, fedasync_poly so every weight is its own): the lags
    and weights equal, p' and v' equal bit for bit after every push (the
    same elementwise K1 with the same f32 scalars, one launch a shard
    against one launch for the whole model), v_norm within rel 1e-4 (the
    reference's bound: the sums reduce in another order). Returns the
    sharded server's final flat p' and v' for the ingestion phase."""
    from repro_torch.kernels.fused_update.ops import flatten_concat
    core = AsyncParameterServer(params, eta=0.05, beta=0.9,
                                aggregation="fedasync_poly", device="cuda")
    shd = ShardedAsyncParameterServer(params, eta=0.05, beta=0.9,
                                      aggregation="fedasync_poly",
                                      n_shards=LM_SHARDS, device="cuda")
    pulled, weights, launches = {}, [], [0, 0]
    for op, cid, seed in LM_STREAM:
        if op == "pull":    # the shard tuple: no copy until the push
            core.pull(cid)
            pulled[cid] = shd.pull_flat(cid)[0]
            continue
        new = lm_stream_new(torch.cat(pulled.pop(cid)), seed)
        for i, server in enumerate((core, shd)):
            k1.launches = 0
            r = server.push(cid, shd.spec.unflatten(new))
            launches[i] += k1.launches
            weights.append((r.lag, r.applied_weight))
        assert weights[-1] == weights[-2], weights[-2:]
        p_core = flatten_concat(core.params)
        v_core = flatten_concat(core._v)
        p_shd = shd.spec.join(shd.snapshot_flat()[0])
        v_shd = torch.cat([st.momentum for st in shd._shards])
        assert torch.equal(p_core, p_shd) and torch.equal(v_core, v_shd), \
            (cid, seed)
        np.testing.assert_allclose(shd.v_norm, core.v_norm, rtol=1e-4)
        del p_core, v_core, new
    shd.assert_consistent()
    pushes = sum(op == "push" for op, _, _ in LM_STREAM)
    assert launches == [pushes, LM_SHARDS * pushes], launches
    print(f"sharded server ({LM_SHARDS} shards) vs AsyncParameterServer at "
          f"{QWEN_N} parameters, {pushes} fedasync_poly pushes (lag, "
          f"weight) {weights[::2]}: p' and v' equal bit for bit after every "
          f"push; v_norm {shd.v_norm!r} vs {core.v_norm!r} (rel "
          f"{abs(shd.v_norm / core.v_norm - 1)!r}); K1 launches {launches[0]}"
          f" vs {launches[1]}; peak memory {peak_gib()!r} GiB", flush=True)
    return p_shd.cpu(), v_shd.cpu()


def phase_ingest(serve, FleetMonitor, params, expected):
    """The ingestion pipeline at full width with each codec: three
    ``ServeClient``s play ``LM_STREAM`` into a 4-shard server through
    ``IngestPipeline`` with a ``FleetMonitor``; client 2 dies after two
    of its four shard packets, is evicted by the sweep, recovers and
    re-sends the rest; client 0 re-sends a committed push whole. Every
    push applies exactly once (applied = version = pushes, one duplicate
    a re-sent packet); under ``NullCodec`` p' and v' equal the sharded
    server's of the same stream (``expected``, on the host) bit for
    bit."""
    results = {}
    for codec in (serve.NullCodec(), serve.Int8Codec(),
                  serve.TopKDeltaCodec()):
        shd = serve.ShardedAsyncParameterServer(
            params, eta=0.05, beta=0.9, aggregation="fedasync_poly",
            n_shards=LM_SHARDS, device="cuda")
        pipe = serve.IngestPipeline(shd, codec=codec,
                                    monitor=FleetMonitor(timeout_slots=3))
        clients = {i: serve.ServeClient(i, pipe) for i in range(3)}
        sent, slot = {}, 0
        t0 = time.perf_counter()
        for op, cid, seed in LM_STREAM:
            slot += 1
            c = clients[cid]
            if op == "pull":
                c.pull()
                continue
            new = lm_stream_new(torch.cat(c.base), seed)
            if cid == 2:    # dies after two of its shard packets
                pid, acc = c.push(new, slot, shards=[0, 1])
                pipe.drain()
                assert pipe.sweep(slot + 10) == {0, 1, 2}
                assert pipe.parked_clients == {2} and shd.version == 3
                slot += 11
                c.resume_push(pid, new, slot)
            else:
                pid, acc = c.push(new, slot)
                assert acc == LM_SHARDS
            sent[cid] = (pid, new)
            pipe.drain()
            del new
        pid, new = sent[0]      # a full resend of a committed push
        c0 = clients[0]
        c0._sent[pid].clear()
        c0.resume_push(pid, new, slot + 1)
        pipe.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        del sent, new
        stats = pipe.stats.as_dict()
        pushes = sum(op == "push" for op, _, _ in LM_STREAM)
        assert stats["applied"] == shd.version == pushes, stats
        assert stats["duplicates"] == LM_SHARDS, stats
        assert stats["evicted"] == 3 and stats["reregistered"] == 1, stats
        assert pipe.pending_pushes == 0 and not pipe.parked_clients
        shd.assert_consistent()
        p = shd.spec.join(shd.snapshot_flat()[0])
        v = torch.cat([st.momentum for st in shd._shards])
        assert bool(torch.isfinite(p).all()) and bool(torch.isfinite(v).all())
        p, v = p.cpu(), v.cpu()
        diff = float((p - expected[0]).abs().max())
        if codec.name == "none":
            assert torch.equal(p, expected[0]) and \
                torch.equal(v, expected[1]), "NullCodec differs from (c)"
        results[codec.name] = diff
        print(f"ingest, codec {codec.name!r}, {LM_SHARDS} shards at "
              f"{QWEN_N} parameters: {stats}; max |p' - sharded server's| "
              f"{diff!r}; wall {wall!r} s; peak memory {peak_gib()!r} GiB",
              flush=True)
        del shd, pipe, clients, p, v
        torch.cuda.empty_cache()
    return results


def time_push_with_topk(AsyncParameterServer, ErrorFeedback, params,
                        ratio, reps=3):
    """One push at full width, timed on the host around work that ends in
    a synchronize: ``AsyncParameterServer.push`` alone, and with the
    trainer's top-k path before it (delta, ``ErrorFeedback.compress``,
    ``decompress``, the rebuilt model). Medians of ``reps``."""
    from repro_torch.kernels.fused_update.ops import tree_map
    server = AsyncParameterServer(params, eta=0.05, beta=0.9,
                                  device="cuda")
    ef = ErrorFeedback(ratio)
    gen = torch.Generator(device="cuda").manual_seed(3)
    new = tree_map(lambda p: p + 1e-3 * torch.randn(
        p.shape, generator=gen, device="cuda"), params)

    def plain():
        server.pull(0)
        server.push(0, new)

    def with_topk():
        server.pull(0)
        delta = tree_map(lambda a, b: a - b, new, params)
        delta = ErrorFeedback.decompress(ef.compress(delta))
        server.push(0, tree_map(lambda b, d: (b.float() + d).to(b.dtype),
                                params, delta))

    times = {}
    for name, fn in (("push", plain), ("push with top-k", with_topk)):
        ts = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        times[name] = float(np.median(ts[1:]))
    print(f"a push at {QWEN_N} parameters (host clock to a synchronize, "
          f"median of {reps} after one warm-up): {times['push']!r} ms "
          f"alone, {times['push with top-k']!r} ms with top-k at ratio "
          f"{ratio} and error feedback", flush=True)
    return times


def phase_checkpoint(train, k1, k2):
    """The trainer with ``ckpt_dir`` in a temporary directory inside the
    checkout (removed afterwards): a save every ``ckpt_every`` slots and
    at the end, the restored checkpoint equal to the final model bit for
    bit, then a resumed run of one slot (too short for a push), whose
    model equals the saved one bit for bit and whose clock continues."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.kernels.fused_update.ops import tree_leaves
    build = os.path.join(ROOT, ".kernel_build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ckpt-", dir=build)
    print(f"checkpoint dir {tmp}: {shutil.disk_usage(tmp).free / 2 ** 30!r}"
          f" GiB free", flush=True)
    try:
        timers = ((train.Checkpointer, "save"), (train.Checkpointer, "wait"))
        out, stats, *_ = run_trainer(train, k1, k2, "checkpointed",
                                     timers=timers, slots=LM_CKPT_SLOTS,
                                     ckpt_dir=tmp, ckpt_every=LM_CKPT_EVERY)
        steps = sorted(os.listdir(tmp))
        assert steps == [f"step_{LM_CKPT_EVERY:08d}",
                         f"step_{LM_CKPT_SLOTS:08d}"], steps
        template = {"params": out["params"],
                    "slot": torch.tensor(0, dtype=torch.int32)}
        t = time.perf_counter()
        restored, step = Checkpointer(tmp).restore(template)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        assert step == LM_CKPT_SLOTS and int(restored["slot"]) == step
        pairs = list(zip(tree_leaves(restored["params"]),
                         tree_leaves(out["params"])))
        assert all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in pairs)
        del restored, pairs
        again, *_ = run_trainer(train, k1, k2, "resumed", slots=1,
                                ckpt_dir=tmp, resume=True)
        assert again["final_slot"] == LM_CKPT_SLOTS + 1
        assert again["updates"] == 0
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(again["params"]), tree_leaves(out["params"])))
        print(f"checkpoint: saves at {steps}, {stats['save'][0]} save "
              f"calls ({stats['save'][1]!r} s on the host, the device-to-"
              f"host copy), waits {stats['wait'][1]!r} s; restore "
              f"{restore_s!r} s; restored and resumed models equal the "
              f"saved one bit for bit", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_trainer_options(train, AsyncParameterServer, serve, FleetMonitor,
                          ErrorFeedback, fused_update, cohort_bytes, k1, k2,
                          params):
    """Phase 7b: K1 on one LM shard, the trainer with ``n_shards``
    (launches = shards x pushes), the sharded server against the
    unsharded one, the ingestion pipeline, compressed pushes and
    checkpoints, each printing its seconds. Returns (K1 shard times and
    error, sharded-run K1 launches, its pushes)."""
    ShardedAsyncParameterServer = serve.ShardedAsyncParameterServer
    live_gib("the trainer's options")
    t = time.perf_counter()
    shard_k1 = phase_k1_shard(fused_update, cohort_bytes)
    print(f"K1 shard phase: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    out, stats, sh_launches, _, _, _ = run_trainer(
        train, k1, k2, "sharded",
        timers=((ShardedAsyncParameterServer, "push"),), n_shards=LM_SHARDS)
    sh_pushes = stats["push"][0]
    assert out["updates"] == sh_pushes > 0, (out["updates"], sh_pushes)
    assert sh_launches == LM_SHARDS * sh_pushes == k1.pushes, \
        (sh_launches, sh_pushes)
    del out
    print(f"LM sharded phase: {time.perf_counter() - t:.1f} s", flush=True)
    live_gib("the sharded server phase")
    t = time.perf_counter()
    peak_gib(reset=True)
    expected = phase_sharded_server(AsyncParameterServer,
                                    ShardedAsyncParameterServer, params, k1)
    print(f"sharded server phase: {time.perf_counter() - t:.1f} s",
          flush=True)
    live_gib("the ingest phase")
    t = time.perf_counter()
    phase_ingest(serve, FleetMonitor, params, expected)
    del expected
    torch.cuda.empty_cache()
    print(f"ingest phase: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    out, *_ = run_trainer(
        train, k1, k2, "compressed",
        timers=((ErrorFeedback, "compress"), (AsyncParameterServer, "push")),
        slots=LM_COMPRESS_SLOTS, compress_ratio=LM_COMPRESS)
    del out
    time_push_with_topk(AsyncParameterServer, ErrorFeedback, params,
                        LM_COMPRESS)
    torch.cuda.empty_cache()
    print(f"LM compressed phase: {time.perf_counter() - t:.1f} s",
          flush=True)
    t = time.perf_counter()
    phase_checkpoint(train, k1, k2)
    torch.cuda.empty_cache()
    print(f"LM checkpoint phase: {time.perf_counter() - t:.1f} s",
          flush=True)
    return shard_k1, sh_launches, sh_pushes


def randn(shape, gen, dtype=torch.float32, scale=1.0):
    return (scale * torch.randn(shape, generator=gen, device="cuda")).to(
        dtype)


def phase_build(cuda_build, names=None):
    """Build the CUDA C++ kernels (one nvcc per source, started together;
    ``names`` a subset of ``SOURCES``) and print what ptxas said about
    registers, shared memory and spills."""
    built = cuda_build.build_all(names or cuda_build.SOURCES)
    for name, (path, secs) in built.items():
        print(f"build {name}: {path.name} ready after {secs:.1f} s",
              flush=True)
        for line in cuda_build.ptxas_report(name).splitlines():
            if "Used" in line or "spill" in line or "Compiling" in line:
                print(f"ptxas {name}: {line.strip()[:150]}", flush=True)


def phase_k4(flash_attention):
    """K4 (CUDA C++) against its plain version on the same CUDA tensors:
    the TestFlashAttention shapes, a ragged S, the Qwen3 serving shape and
    the newer configurations' (``K4_ZOO``), causal and not, at the
    reference's bounds (2e-5 in f32: the CUDA-core form; 2e-2 in bf16: the
    wgmma form, which rounds P to bf16), then the serving shape in bf16
    with its times: the kernel, the plain version, the bound and torch's
    SDPA (one call computing the same function; the port never calls
    it)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    max_err = 0.0
    for B, H, KV, S, d in K4_SHAPES + (K4_SERVE,) + tuple(K4_ZOO.values()):
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            q = randn((B, H, S, d), gen, dtype)
            k, v = (randn((B, KV, S, d), gen, dtype) for _ in "kv")
            for causal in (True, False):
                out = flash_attention(q, k, v, causal=causal, kernel="cuda")
                ref = flash_attention(q, k, v, causal=causal,
                                      kernel="reference")
                err, ok = max_violation(out.float(), ref.float(), tol, tol)
                assert ok and out.dtype == dtype, (B, H, KV, S, d, dtype,
                                                   causal, err)
                max_err = max(max_err, err)
            print(f"K4 {(B, H, KV, S, d)} {str(dtype)[6:]}: causal and "
                  f"full match the plain version at {tol} (max abs err "
                  f"{err!r} full)", flush=True)
    ms, plain, bound, by, sdpa, _ = k4_times(flash_attention, K4_SERVE,
                                             gen, "serving shape")
    return max_err, (ms, plain, bound, by, sdpa)


def k4_times(flash_attention, shape, gen, label):
    """K4 at ``shape`` (B, H, KV, S, d) in bf16, causal, on fresh inputs:
    the kernel against its plain version at the bf16 bound (2e-2), then
    times by CUDA events: the kernel, the plain version, torch's SDPA (one
    call computing the same function; the port never calls it), and the
    bound (the larger of the bytes at the HBM rate and the FLOPs of j <= i
    at the bf16 tensor-core peak). Returns (ms, plain ms, bound ms, bound
    by, SDPA ms, max abs err)."""
    import torch.nn.functional as F
    B, H, KV, S, d = shape
    q = randn((B, H, S, d), gen, torch.bfloat16)
    k, v = (randn((B, KV, S, d), gen, torch.bfloat16) for _ in "kv")
    out = flash_attention(q, k, v, causal=True, kernel="cuda")
    ref = flash_attention(q, k, v, causal=True, kernel="reference")
    err, ok = max_violation(out.float(), ref.float(), 2e-2, 2e-2)
    assert ok and out.dtype == torch.bfloat16, (shape, err)
    ms = time_ms(lambda: flash_attention(q, k, v, kernel="cuda"), 50)
    plain = time_ms(lambda: flash_attention(q, k, v, kernel="reference"), 10)
    sdpa = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 50)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())   # q, o, k, v
    flops = 4 * B * H * d * S * (S + 1) // 2     # QK^T and PV, j <= i only
    bound = max(nbytes / HBM_BPS, flops / BF16_FLOPS) * 1e3
    by = "bytes" if nbytes / HBM_BPS >= flops / BF16_FLOPS else "operations"
    print(f"K4 {label} {shape} bf16 causal: equals the plain version at "
          f"2e-2 (max abs err {err!r}); kernel {ms:.6f} ms (the first, "
          f"CUDA-core form at the Qwen3 serving shape: "
          f"{FIRST_FORM_MS['K4']} ms), plain {plain:.6f} ms, SDPA "
          f"{sdpa:.6f} ms, bound {bound:.6f} ms by {by} ({nbytes} B at 3.35 "
          f"TB/s; {flops} FLOP take {flops / BF16_FLOPS * 1e3:.6f} ms at "
          f"the bf16 tensor-core peak, {flops / F32_FLOPS * 1e3:.6f} ms on "
          f"the f32 CUDA cores)", flush=True)
    return ms, plain, bound, by, sdpa, err


def phase_k4_zoo(flash_attention):
    """K4 at the three shapes the newer configurations bring (``K4_ZOO``),
    each against its plain version and timed. Returns {arch: (ms, plain
    ms, bound ms, bound by, SDPA ms, max abs err)}."""
    gen = torch.Generator(device="cuda").manual_seed(24)
    return {arch: k4_times(flash_attention, shape, gen, arch)
            for arch, shape in K4_ZOO.items()}


def k3_fold(X, dtv, A, Bh, Ch):
    B_, S, nh = dtv.shape
    fold = [t.movedim(2, 1).reshape(B_ * nh, S, -1).contiguous()
            for t in (X, Bh, Ch)]
    return (fold[0], dtv.movedim(2, 1).reshape(B_ * nh, S).contiguous(),
            A.repeat(B_), fold[1], fold[2])


def k3_bf16_check(ssd, args, chunk):
    """The bf16 K3 on the 4-D views ``args`` against the rounding-matched
    plain version at 1e-4 x max(1, max|ref|) plus its rounding-boundary
    slack, and against the f32 plain version at the derived bf16 bound
    (kernels/ssd_scan/ref.py). Returns (max abs err against the rounded
    version, the largest ratio of |kernel - f32| to the bound, the
    outputs)."""
    got = ssd.ssd_intra_chunk_cuda(*args, chunk=chunk)
    comp = ssd.ssd_intra_chunk_ref_bf16(*args, chunk=chunk)
    ref = ssd.ssd_intra_chunk_ref(*args, chunk=chunk)
    slack = (ssd.bf16_rounding_slack(*args, chunk=chunk), 0.0, 0.0, 0.0)
    bound = ssd.bf16_bound(*args, chunk=chunk)
    err, ratio = 0.0, 0.0
    for i, (a, c, r, sl) in enumerate(zip(got, comp, ref, slack)):
        assert bool(torch.isfinite(a).all()), i
        d = (a - c).abs()
        tol = 1e-4 * max(1.0, float(c.abs().max()))
        assert bool(torch.all(d <= tol + sl)), (i, float(d.max()), tol)
        err = max(err, float(d.max()))
        if i < 2:
            dr = (a - r).abs()
            assert bool(torch.all(dr <= bound[i])), i
            ratio = max(ratio, float((dr / bound[i].clamp_min(1e-30)).max()))
    return err, ratio, got


def phase_k3(ssd, ssm_model):
    """K3 (CUDA C++), both forms. f32 (CUDA cores) against its plain
    version and the sequential recurrence at the reference's bound, 1e-4
    (f32 sums in another order): the TestSSDScan shapes, an init_state
    continuation and an S that is no chunk multiple through the model's
    padded ssd_chunked. bf16 (wgmma fed by TMA) at the TestSSDScan shapes
    with one group and the serving shape (batch 8 x 32 heads of one group)
    on the model's (B, S, heads, .) views: against the rounding-matched
    plain version and the f32 one (``k3_bf16_check``), with its times
    beside both interfaces' bounds. No single PyTorch call computes K3's
    function."""
    gen = torch.Generator(device="cuda").manual_seed(3)

    def inputs(B, S, nh, ph, s, dtype=torch.float32, g=None):
        X = randn((B, S, nh, ph), gen, dtype)
        dtv = torch.nn.functional.softplus(randn((B, S, nh), gen))
        A = -torch.exp(randn((nh,), gen, scale=0.3))
        Bh, Ch = (randn((B, S, g or nh, s), gen, dtype, 0.5) for _ in "BC")
        return X, dtv, A, Bh, Ch

    def check(a, b, tol, scaled=False):
        atol = tol * max(1.0, float(b.abs().max())) if scaled else tol
        err, ok = max_violation(a.float(), b.float(), tol, atol)
        assert ok and bool(torch.isfinite(a).all()), err
        return err

    def views(X, dtv, A, Bg, Cg):
        return (X.movedim(2, 1), dtv.movedim(2, 1), A, Bg.movedim(2, 1),
                Cg.movedim(2, 1))

    max_err, max_ratio = 0.0, 0.0
    for B, S, nh, ph, s, chunk in K3_SHAPES:
        args = inputs(B, S, nh, ph, s)
        folded = k3_fold(*args)
        for a, b in zip(ssd.ssd_intra_chunk_cuda(*folded, chunk=chunk),
                        ssd.ssd_intra_chunk_ref(*folded, chunk=chunk)):
            max_err = max(max_err, check(a, b, 1e-4))
        y, f = ssd.ssd_chunked(*args, chunk, kernel="cuda")
        yr, fr = ssd.ssd_chunked_ref(*args)
        check(y, yr, 1e-4)
        check(f, fr, 1e-4)
        err, ratio, _ = k3_bf16_check(
            ssd, views(*inputs(B, S, nh, ph, s, torch.bfloat16, g=1)), chunk)
        max_err, max_ratio = max(max_err, err), max(max_ratio, ratio)
        print(f"K3 {(B, S, nh, ph, s, chunk)}: f32 intra-chunk outputs match "
              f"the plain version, y and the final state the sequential "
              f"recurrence, at 1e-4; bf16 (one group) max abs err {err!r} "
              f"against the rounded plain version, |kernel - f32| at "
              f"{ratio:.3f} of the bf16 bound", flush=True)
    X, dtv, A, Bh, Ch = inputs(1, 64, 2, 8, 16)
    y_all, f_all = ssd.ssd_chunked(X, dtv, A, Bh, Ch, 16, kernel="cuda")
    _, f1 = ssd.ssd_chunked(X[:, :32], dtv[:, :32], A, Bh[:, :32],
                            Ch[:, :32], 16, kernel="cuda")
    y2, f2 = ssd.ssd_chunked(X[:, 32:], dtv[:, 32:], A, Bh[:, 32:],
                             Ch[:, 32:], 16, init_state=f1, kernel="cuda")
    check(y2, y_all[:, 32:], 1e-4)
    check(f2, f_all, 1e-4)
    args = inputs(1, 300, 4, 64, 128)        # 300 = 256 + 44: padded
    y, f = ssm_model.ssd_chunked(*args, 256, kernel="cuda")
    yr, fr = ssd.ssd_chunked_ref(*args)
    check(y, yr, 1e-4)
    check(f, fr, 1e-4)
    print("K3: init_state continuation and the padded model ssd_chunked "
          "(S=300, chunk 256) match at 1e-4", flush=True)

    B, S, nh, ph, s, Q = K3_SERVE
    X = randn((B, S, nh, ph), gen, torch.bfloat16)
    dtv = torch.nn.functional.softplus(randn((B, S, nh), gen) - 4.0)
    A = -torch.linspace(1.0, 16.0, nh, device="cuda")
    Bg, Cg = (randn((B, S, 1, s), gen, torch.bfloat16, 0.5) for _ in "BC")
    args = views(X, dtv, A, Bg, Cg)
    err, ratio, got = k3_bf16_check(ssd, args, Q)
    max_err, max_ratio = max(max_err, err), max(max_ratio, ratio)
    ms = time_ms(lambda: ssd.ssd_intra_chunk_cuda(*args, chunk=Q), 50)
    plain = time_ms(lambda: ssd.ssd_intra_chunk_ref(*args, chunk=Q), 10)
    nc = S // Q
    out_bytes = sum(t.numel() * 4 for t in got)
    nbytes = sum(t.numel() * t.element_size() for t in (X, dtv, A, Bg, Cg)) \
        + out_bytes
    # the per-head interface of the first kernel read B and C once per head
    # and A per (batch, head)
    head_bytes = nbytes + (nh - 1) * 2 * Bg.numel() * Bg.element_size() \
        + (B - 1) * A.numel() * 4
    flops = B * nh * nc * (2 * Q * Q * s + 2 * Q * Q * ph + 2 * Q * s * ph)
    bound = max(nbytes / HBM_BPS, flops / BF16_FLOPS) * 1e3
    print(f"K3 serving shape (batch, S, heads, ph, s, Q) = {K3_SERVE}, one "
          f"group, bf16: max abs err {err!r} against the rounded plain "
          f"version, |kernel - f32| at {ratio:.3f} of the bf16 bound; kernel "
          f"{ms:.6f} ms (the first, CUDA-core form: "
          f"{FIRST_FORM_MS['K3']} ms), "
          f"plain {plain:.6f} ms, bound {bound:.6f} ms ({nbytes} B at 3.35 "
          f"TB/s with B/C read once per group; the per-head interface "
          f"{head_bytes} B, {head_bytes / HBM_BPS * 1e3:.6f} ms; {flops} FLOP "
          f"as the TPU kernel counts them take "
          f"{flops / BF16_FLOPS * 1e3:.6f} ms at the bf16 tensor-core peak); "
          f"no single PyTorch call computes it", flush=True)
    return max_err, (ms, plain, bound, "bytes" if nbytes / HBM_BPS >=
                     flops / BF16_FLOPS else "operations", None)


def serve_prompts(cfg):
    from repro_torch.data.synthetic import synthetic_tokens
    n = SERVE_BATCH * SERVE_PROMPT
    return synthetic_tokens(n, cfg.vocab_size, seed=3).reshape(
        SERVE_BATCH, SERVE_PROMPT)


def prefill_logits(model, params, prompts):
    with torch.inference_mode():
        cache = model.init_cache(prompts.shape[0],
                                 prompts.shape[1] + SERVE_GEN,
                                 device="cuda")
        logits, _ = model.prefill(params, {"tokens": torch.from_numpy(
            prompts.astype(np.int64)).cuda()}, cache)
    return logits[:, -1].float()


def compare_routes(label, auto, ref):
    """The kernel route's prefill logits against the plain route's: the
    max abs difference, and the argmax equal on every row whose top-2
    margin under the plain route exceeds 0.1 (bf16 near-ties may flip)."""
    diff = float((auto - ref).abs().max())
    top2 = torch.topk(ref, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 0.1
    same = torch.argmax(auto, -1) == torch.argmax(ref, -1)
    assert bool(torch.isfinite(auto).all())
    assert bool(same[clear].all()), (label, same, clear)
    print(f"{label}: prefill logits, kernel vs plain route: max abs diff "
          f"{diff!r} (logits up to {float(ref.abs().max())!r}); argmax "
          f"equal on {int(same[clear].sum())} of {int(clear.sum())} rows "
          f"with a top-2 margin > 0.1 ({int(same.sum())} of {len(same)} "
          f"rows in all)", flush=True)
    return diff


def profile_decode(srv, prompts, n_steps=4):
    """torch.profiler over a few decode steps after a prefill: device busy
    time against the wall, the idle share and the kernels per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    m, params = srv.model, srv.params
    with torch.inference_mode():
        cache = m.init_cache(prompts.shape[0], prompts.shape[1] + n_steps + 1,
                             device="cuda")
        logits, cache = m.prefill(params, {"tokens": torch.from_numpy(
            prompts.astype(np.int64)).cuda()}, cache)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        logits, cache = m.decode_step(params, cache, {"tokens": tok})  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_steps):
                tok = torch.argmax(logits[:, -1], -1)[:, None]
                logits, cache = m.decode_step(params, cache, {"tokens": tok})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(r[1] for r in rows) * 1e-6
    n_kernels = sum(r[2] for r in rows)
    print(f"{srv.cfg.name} decode profile: {n_steps} steps, wall {wall!r} s "
          f"(profiled), {wall / n_steps * 1e3!r} ms/step, device busy "
          f"{busy!r} s, idle share {1.0 - busy / wall!r}, "
          f"{n_kernels / n_steps!r} kernels per step", flush=True)
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"{srv.cfg.name} decode profile:   {us * 1e-3:9.3f} ms  "
              f"{count:6d}x  {key[:90]}", flush=True)


def profile_prefill(srv, prompts, top=10):
    """torch.profiler over one prefill of the serving prompts (after the
    warm-up generate): device busy time against the wall, the idle share,
    and the kernels that take the most device time, the hand kernel's
    share among them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    m, params = srv.model, srv.params
    with torch.inference_mode():
        cache = m.init_cache(prompts.shape[0], prompts.shape[1] + 1,
                             device="cuda")
        tokens = torch.from_numpy(prompts.astype(np.int64)).cuda()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            m.prefill(params, {"tokens": tokens}, cache)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(r[1] for r in rows) * 1e-6
    print(f"{srv.cfg.name} prefill profile: wall {wall * 1e3!r} ms "
          f"(profiled), device busy {busy * 1e3!r} ms, idle share "
          f"{1.0 - busy / wall!r}, {sum(r[2] for r in rows)} kernels",
          flush=True)
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"{srv.cfg.name} prefill profile:   {us * 1e-3:9.3f} ms "
              f"({us * 1e-6 / busy:6.1%})  {count:5d}x  {key[:90]}",
              flush=True)


def timed_generate(srv, prompts, counter, on_start=None, warm_len=64):
    """``srv.generate(prompts, SERVE_GEN)`` on the card after a short
    warm-up generate (prompts cut to ``warm_len`` tokens), counting
    ``counter``'s launches over exactly that call (``on_start()`` runs
    just before it); the prefill and each decode step timed by CUDA
    events around the model's calls. Returns (tokens, wall s, launches,
    prefill ms, [decode ms], peak bytes)."""
    srv.generate(prompts[:, :warm_len], 2)                # warm-up
    spans = {"prefill": [], "decode_step": []}

    def timed(name):
        fn = getattr(srv.model, name)

        def call(*a, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **k)
            e1.record()
            spans[name].append((e0, e1))
            return out
        return call

    model = srv.model
    srv.model = model._replace(prefill=timed("prefill"),
                               decode_step=timed("decode_step"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if on_start is not None:
        on_start()
    counter.launches = 0
    t0 = time.perf_counter()
    toks = srv.generate(prompts, SERVE_GEN)
    wall = time.perf_counter() - t0
    launches = counter.launches
    srv.model = model
    peak = torch.cuda.max_memory_allocated()
    prefill_ms = spans["prefill"][0][0].elapsed_time(spans["prefill"][0][1])
    decode_ms = [a.elapsed_time(b) for a, b in spans["decode_step"]]
    assert toks.shape == (SERVE_BATCH, SERVE_GEN) and toks.dtype == np.int32
    assert ((toks >= 0) & (toks < srv.cfg.vocab_size)).all()
    return toks, wall, launches, prefill_ms, decode_ms, peak


def run_serve(BatchedServer, build_model, cfg, params, counter, per_layer):
    """``BatchedServer.generate`` of SERVE_BATCH prompts of SERVE_PROMPT
    tokens and SERVE_GEN new tokens on the card (``timed_generate``); then
    the kernel-vs-plain prefill comparison and a profile of one prefill
    and of a few decode steps. Returns (server, prompts, tokens,
    launches)."""
    srv = BatchedServer(cfg, params=params, device="cuda")
    prompts = serve_prompts(cfg)
    toks, wall, launches, prefill_ms, decode_ms, peak = timed_generate(
        srv, prompts, counter)
    model = srv.model
    assert launches == per_layer * cfg.num_layers, (launches,
                                                    cfg.num_layers)
    print(f"serve {cfg.name} ({cfg.param_count()} parameters, "
          f"attention_impl={cfg.attention_impl}): generate {SERVE_BATCH} x "
          f"{SERVE_PROMPT} prompt tokens + {SERVE_GEN} new: wall {wall!r} s, "
          f"{toks.size / wall!r} generated tokens/s; prefill {prefill_ms!r} "
          f"ms (with the first kernels: "
          f"{FIRST_FORM_PREFILL_MS[cfg.name]} ms), decode "
          f"{sum(decode_ms) / len(decode_ms)!r} ms/token "
          f"(CUDA events around each model call, {len(decode_ms)} steps); "
          f"kernel launches {launches} ({cfg.num_layers} layers); peak "
          f"memory {peak / 2 ** 30!r} GiB; first row {toks[0][:8].tolist()}",
          flush=True)
    auto = prefill_logits(model, srv.params, prompts)
    counted = counter.launches
    ref = prefill_logits(build_model(cfg, kernel="reference"), srv.params,
                         prompts)
    assert counter.launches == counted, "the plain route launched a kernel"
    compare_routes(f"serve {cfg.name}", auto, ref)
    profile_prefill(srv, prompts)
    profile_decode(srv, prompts)
    return srv, prompts, toks, launches


def phase_serve_qwen(BatchedServer, build_model, cfg, params, k4):
    """Qwen3-0.6B at full width under attention_impl="flash" (K4 on each
    layer's prefill), then the same prompts on the einsum route."""
    flash = dataclasses.replace(cfg, attention_impl="flash")
    srv, prompts, toks, launches = run_serve(
        BatchedServer, build_model, flash, params, k4, per_layer=1)
    xla_cfg = dataclasses.replace(cfg, attention_impl="xla")
    xla = BatchedServer(xla_cfg, params=params, device="cuda")
    k4.launches = 0
    t0 = time.perf_counter()
    xla_toks = xla.generate(prompts, SERVE_GEN)
    wall = time.perf_counter() - t0
    assert k4.launches == 0, "the einsum route launched K4"
    xla_logits = prefill_logits(xla.model, params, prompts)
    flash_logits = prefill_logits(srv.model, params, prompts)
    print(f"serve {cfg.name}: the einsum route (attention_impl=xla, "
          f"_sdpa over the whole cache): generate wall {wall!r} s; prefill "
          f"logits max abs diff to the flash route "
          f"{float((xla_logits - flash_logits).abs().max())!r}; equal "
          f"greedy tokens {float((xla_toks == toks).mean())!r} of "
          f"{toks.size}", flush=True)
    return launches


def phase_serve_mamba(BatchedServer, build_model, k3):
    """Mamba2-370m at full width, random weights from seed 0 (K3 on each
    layer's prefill)."""
    from repro_torch.configs import get_config
    cfg = get_config("mamba2-370m")
    srv = BatchedServer(cfg, seed=0, device="cuda")
    return run_serve(BatchedServer, build_model, cfg, srv.params, k3,
                     per_layer=1)[3]


def card_params(build_model, cfg, seed=0):
    """``cfg``'s parameters drawn on the card from a CUDA generator seeded
    with ``seed`` (a CPU draw of billions of parameters takes minutes).
    Returns (params, seconds to draw them)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


def serve_zoo_model(BatchedServer, build_model, cfg, k4, moe_mod, note=""):
    """One configuration served on the card under attention_impl="flash"
    with random weights from seed 0: ``timed_generate``, K4 launched once a
    layer, and (the MoE family) the (token, expert) slots the capacity
    dropped in that generate's prefill (decode takes the dense combine).
    Returns (server, prompts, tokens, figures)."""
    cfg = dataclasses.replace(cfg, attention_impl="flash")
    params, init_s = card_params(build_model, cfg)
    srv = BatchedServer(cfg, params=params, device="cuda")
    prompts = serve_prompts(cfg)
    moe = cfg.family == "moe"
    # the warm-up at the full prompt length: a MoE prefill's sorted
    # dispatch runs only from 4 x experts tokens a row
    toks, wall, launches, prefill_ms, decode_ms, peak = timed_generate(
        srv, prompts, k4,
        on_start=(lambda: setattr(moe_mod, "DROPPED", [])) if moe else None,
        warm_len=SERVE_PROMPT)
    dropped = None
    if moe:
        dropped = sum(int(d) for d in moe_mod.DROPPED)
        moe_mod.DROPPED = None
    assert launches == cfg.num_layers, (cfg.name, launches, cfg.num_layers)
    slots = cfg.num_layers * SERVE_BATCH * SERVE_PROMPT * \
        cfg.num_experts_per_tok if moe else 0
    fig = dict(tokens_per_s=toks.size / wall, wall_s=wall,
               prefill_ms=prefill_ms,
               decode_ms=sum(decode_ms) / len(decode_ms),
               peak_gib=peak / 2 ** 30, k4_launches=launches,
               layers=cfg.num_layers, params=cfg.param_count(),
               dropped_slots=dropped, routed_slots=slots or None)
    moe_note = ""
    if moe:
        C = max(int(SERVE_PROMPT * cfg.num_experts_per_tok / cfg.num_experts
                    * cfg.moe_capacity_factor), 1)
        moe_note = (f"; prefill's sorted dispatch (capacity {C} a row and "
                    f"expert) dropped {dropped} of {slots} (token, expert) "
                    f"slots ({dropped / slots:.2%}) over {cfg.num_layers} "
                    "layers")
    print(f"serve {cfg.name}{note} ({cfg.param_count()} parameters, "
          f"{cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"attention_impl=flash, random weights from seed 0 drawn on the "
          f"card in {init_s!r} s): generate {SERVE_BATCH} x {SERVE_PROMPT} "
          f"prompt tokens + {SERVE_GEN} new: wall {wall!r} s, "
          f"{toks.size / wall!r} generated tokens/s; prefill {prefill_ms!r} "
          f"ms, decode {fig['decode_ms']!r} ms/token (CUDA events, "
          f"{len(decode_ms)} steps); K4 launches {launches}; peak memory "
          f"{fig['peak_gib']!r} GiB{moe_note}; first row "
          f"{toks[0][:8].tolist()}", flush=True)
    return srv, prompts, toks, fig


def phase_zoo(BatchedServer, build_model, get_config, k4, moe_mod):
    """The LM zoo's newer configurations on the card (random weights,
    8 x 512-token prompts + 32 greedy tokens, attention_impl="flash"):
    (a) granite-moe-1b-a400m at full width, then its einsum route on the
    same weights: bf16 prefill logits at the Qwen3 phase's bound
    (``compare_routes``), and in f32 (K4's CUDA-core form) the generated
    tokens equal; (b) qwen2.5-3b at full width, and its chunked-attention
    prefill (``ZOO_Q_BLOCK``) against the einsum route's; (c)
    phi4-mini-3.8b at full width; (d) internlm2-20b and qwen3-moe-30b-a3b
    at their published widths, depth cut to ``ZOO_CUT``. Returns {arch:
    figures}."""
    out = {}
    t = time.perf_counter()
    cfg = get_config("granite-moe-1b-a400m")
    srv, prompts, toks, out[cfg.name] = serve_zoo_model(
        BatchedServer, build_model, cfg, k4, moe_mod)
    params = srv.params
    xla = BatchedServer(dataclasses.replace(cfg, attention_impl="xla"),
                        params=params, device="cuda")
    k4.launches = 0
    xla_toks = xla.generate(prompts, SERVE_GEN)
    assert k4.launches == 0, "the einsum route launched K4"
    diff = compare_routes(f"serve {cfg.name}, flash (K4) vs einsum route, "
                          "bf16", prefill_logits(srv.model, params, prompts),
                          prefill_logits(xla.model, params, prompts))
    bf16_equal = float((xla_toks == toks).mean())
    f32 = {impl: BatchedServer(dataclasses.replace(
        cfg, dtype="float32", attention_impl=impl), params=params,
        device="cuda") for impl in ("flash", "xla")}
    k4.launches = 0
    f_toks = f32["flash"].generate(prompts, SERVE_GEN)
    assert k4.launches == cfg.num_layers, k4.launches
    x_toks = f32["xla"].generate(prompts, SERVE_GEN)
    assert k4.launches == cfg.num_layers, "the einsum route launched K4"
    f_log = prefill_logits(f32["flash"].model, params, prompts)
    x_log = prefill_logits(f32["xla"].model, params, prompts)
    f32_diff = float((f_log - x_log).abs().max())
    assert np.array_equal(f_toks, x_toks), (f_toks, x_toks)
    assert f32_diff < 1e-3 * max(1.0, float(x_log.abs().max())), f32_diff
    out[cfg.name].update(bf16_route_diff=diff, bf16_equal_tokens=bf16_equal,
                         f32_route_diff=f32_diff)
    print(f"serve {cfg.name}: in bf16 the einsum route's greedy tokens equal "
          f"the flash route's on {bf16_equal!r} of {toks.size}; in f32 "
          f"(K4's CUDA-core form) all {f_toks.size} generated tokens equal, "
          f"prefill logits max abs diff {f32_diff!r} (bound 1e-3 x max(1, "
          f"max|logit|))", flush=True)
    del srv, xla, f32, params
    torch.cuda.empty_cache()
    print(f"zoo (a) granite: {time.perf_counter() - t:.1f} s", flush=True)

    t = time.perf_counter()
    cfg = get_config("qwen2.5-3b")
    srv, prompts, _, out[cfg.name] = serve_zoo_model(
        BatchedServer, build_model, cfg, k4, moe_mod)
    params = srv.params
    chunked = dataclasses.replace(cfg, attention_impl="chunked",
                                  attn_q_block=ZOO_Q_BLOCK)
    k4.launches = 0
    c_log = prefill_logits(build_model(chunked), params, prompts)
    x_log = prefill_logits(build_model(dataclasses.replace(
        cfg, attention_impl="xla")), params, prompts)
    assert k4.launches == 0, "the chunked or einsum route launched K4"
    out[cfg.name]["chunked_diff"] = compare_routes(
        f"serve {cfg.name}, chunked attention (attn_q_block {ZOO_Q_BLOCK}: "
        f"{SERVE_PROMPT // ZOO_Q_BLOCK} blocks and a tail of "
        f"{SERVE_PROMPT % ZOO_Q_BLOCK}) vs einsum route, bf16", c_log, x_log)
    del srv, params
    torch.cuda.empty_cache()
    print(f"zoo (b) qwen2.5-3b: {time.perf_counter() - t:.1f} s", flush=True)

    t = time.perf_counter()
    cfg = get_config("phi4-mini-3.8b")
    srv, _, _, out[cfg.name] = serve_zoo_model(
        BatchedServer, build_model, cfg, k4, moe_mod)
    del srv
    torch.cuda.empty_cache()
    print(f"zoo (c) phi4-mini-3.8b: {time.perf_counter() - t:.1f} s",
          flush=True)

    for arch, layers in ZOO_CUT.items():
        t = time.perf_counter()
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=layers)
        note = (f", depth cut to {layers} of {full.num_layers} layers "
                f"({full.param_count() * 4 / 1e9:.1f} GB of f32 weights at "
                f"full depth)")
        srv, _, _, out[arch] = serve_zoo_model(
            BatchedServer, build_model, cfg, k4, moe_mod, note=note)
        out[arch]["full_layers"] = full.num_layers
        del srv
        torch.cuda.empty_cache()
        print(f"zoo (d) {arch}: {time.perf_counter() - t:.1f} s",
              flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(ROOT, ".kernel_build", "triton"))
    from repro_torch.core import (AsyncParameterServer, Scenario,
                                  make_ml_hooks, run_sweep)
    from repro_torch.kernels import online_replay
    from repro_torch.kernels import fused_update
    from repro_torch.kernels.fused_update import (fused_apply_triton,
                                                  fused_update_flat,
                                                  fused_update_triton)
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.kernels.fused_update.kernel import (
        BYTES_PER_ELEMENT, HBM_BYTES_PER_S, cohort_bytes, ticket_counter)
    from repro_torch.kernels import _cuda_build, ssd_scan
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_cuda)
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import build_model, moe as moe_mod, \
        ssm as ssm_model
    from repro_torch import serve
    from repro_torch.fault import FleetMonitor
    from repro_torch.optim import ErrorFeedback
    import triton

    def bound_ms(n):    # K2: 3 f32 reads + 2 f32 writes an element + sumsq
        return (BYTES_PER_ELEMENT * n + 4) / HBM_BYTES_PER_S * 1e3

    # ---- 1. environment --------------------------------------------------
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, triton {triton.__version__}, CUDA "
          f"{torch.version.cuda}, device {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}; cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}, cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)

    # ---- 1b. the CUDA C++ kernels: build, then K4 and K3 against their
    # plain versions ---------------------------------------------------------
    t = time.perf_counter()
    phase_build(_cuda_build)
    print(f"CUDA build phase: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    k4_err, k4_times = phase_k4(flash_attention)
    k4_zoo = phase_k4_zoo(flash_attention)
    k4_err = max([k4_err] + [v[5] for v in k4_zoo.values()])
    print(f"K4 phase: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    k3_err, k3_times = phase_k3(ssd_scan, ssm_model)
    print(f"K3 phase: {time.perf_counter() - t:.1f} s", flush=True)
    torch.cuda.empty_cache()

    # ---- 2. K1 against its plain version ---------------------------------
    t = time.perf_counter()
    max_err, times = phase_k1(fused_update, cohort_bytes, ticket_counter)
    print(f"K1 phase: {time.perf_counter() - t:.1f} s", flush=True)

    # ---- 3. the main path on the card ------------------------------------
    t = time.perf_counter()
    online, wall, launches, pushes, chunks, _, _ = run_main(
        Scenario, "online", "cuda", fused_apply_triton)
    assert online.updates > 0, "the online policy made no update"
    assert launches == chunks, (launches, chunks)
    assert pushes == len(online.push_log) == online.updates, \
        (pushes, len(online.push_log), online.updates)
    print(f"main path phase: {time.perf_counter() - t:.1f} s", flush=True)

    t = time.perf_counter()
    profile_main(Scenario, horizon_s=300)
    print(f"profile phase: {time.perf_counter() - t:.1f} s", flush=True)

    # ---- 4. the paper's other schedules: immediate, offline, sync -------
    t = time.perf_counter()
    card_runs = phase_schedules(Scenario, fused_apply_triton, online)
    print(f"schedules phase: {time.perf_counter() - t:.1f} s", flush=True)

    # ---- 5. online, offline and sync again on the CPU ---------------------
    t = time.perf_counter()
    phase_cpu(Scenario, fused_apply_triton, card_runs)
    print(f"CPU phase: {time.perf_counter() - t:.1f} s", flush=True)

    # ---- 5b. the aggregation rules beyond replace -------------------------
    t = time.perf_counter()
    gap_launches, gap_host_ms = phase_rules(Scenario, fused_apply_triton,
                                            online)
    print(f"rules phase: {time.perf_counter() - t:.1f} s", flush=True)

    # ---- 5c. run-to-run repeatability on the card -------------------------
    t = time.perf_counter()
    phase_repeat(Scenario, fused_apply_triton)
    print(f"repeat phase: {time.perf_counter() - t:.1f} s", flush=True)

    # ---- 5d. the loop oracle, the MLP, greedy/eps_greedy, churn -----------
    t = time.perf_counter()
    loop_launches, _ = phase_loop(Scenario, make_ml_hooks,
                                  fused_apply_triton, online)
    print(f"loop phase: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    mlp_launches, mlp_chunks, mlp_err, mlp_times = phase_mlp(
        Scenario, fused_update, cohort_bytes, fused_apply_triton)
    max_err = max(max_err, mlp_err)
    print(f"MLP phase: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    phase_greedy(Scenario, fused_apply_triton)
    print(f"greedy phase: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    phase_churn(Scenario, fused_apply_triton)
    print(f"churn phase: {time.perf_counter() - t:.1f} s", flush=True)

    # ---- 5e. the scan engine: the replay kernel, fleet scale, a sweep ----
    t = time.perf_counter()
    replay = phase_scan(Scenario, run_sweep, online_replay)
    print(f"scan engine phase: {time.perf_counter() - t:.1f} s", flush=True)

    # ---- 6. K2 against its plain version ---------------------------------
    t = time.perf_counter()
    k2_err, k2_times = phase_k2(fused_update_flat, bound_ms)
    print(f"K2 phase: {time.perf_counter() - t:.1f} s", flush=True)

    # ---- 7. the LM path on the card: Qwen3-0.6B at full width --------------
    t = time.perf_counter()
    params, lm_launches = run_lm(train, AsyncParameterServer,
                                 fused_apply_triton, fused_update_triton)
    cfg = get_config("qwen3-0.6b")
    print(f"LM run phase: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    step_err = phase_lm_step(params, cfg, make_train_step,
                             fused_update_triton)
    profile_lm_steps(params, cfg, make_train_step)
    print(f"LM step phase: {time.perf_counter() - t:.1f} s", flush=True)

    # ---- 7b. the trainer's options and the sharded serving tier ---------
    shard_k1, sh_launches, sh_pushes = phase_trainer_options(
        train, AsyncParameterServer, serve, FleetMonitor, ErrorFeedback,
        fused_update, cohort_bytes, fused_apply_triton, fused_update_triton,
        params)

    # ---- 8. serving at full width: Qwen3-0.6B (K4), Mamba2-370m (K3) ----
    t = time.perf_counter()
    k4_launches = phase_serve_qwen(
        BatchedServer, build_model, cfg, params, flash_attention_cuda)
    print(f"serve Qwen3 phase: {time.perf_counter() - t:.1f} s", flush=True)
    del params
    torch.cuda.empty_cache()
    t = time.perf_counter()
    k3_launches = phase_serve_mamba(
        BatchedServer, build_model, ssd_scan.ssd_intra_chunk_cuda)
    print(f"serve Mamba2 phase: {time.perf_counter() - t:.1f} s", flush=True)

    # ---- 8b. the newer configurations: the MoE family, three dense ones --
    t = time.perf_counter()
    zoo = phase_zoo(BatchedServer, build_model, get_config,
                    flash_attention_cuda, moe_mod)
    print(f"zoo phase: {time.perf_counter() - t:.1f} s", flush=True)

    # ---- 9. the kernels record ---------------------------------------------
    ms, plain_ms, b_ms = times[LENET_N, 1]
    k2_ms, k2_plain, k2_bound, _ = k2_times[QWEN_N]
    q_ms, q_plain, q_bound = times[QWEN_N, 1]
    print(f"K1 at the LM's {QWEN_N} parameters: kernel {q_ms:.6f} ms, plain "
          f"{q_plain:.6f} ms, bound {q_bound:.6f} ms ({q_bound / q_ms:.1%}); "
          f"{lm_launches[0]} launches in the LM run. K1 at LeNet's "
          f"{LENET_N}: a chunk of 1 push {ms:.6f} ms, of 16 "
          f"{times[LENET_N, 16][0]:.6f} ms, an empty Triton launch "
          f"{times['empty']:.6f} ms; {launches} launches ({chunks} finisher "
          f"chunks) applied {pushes} pushes in the online run. gap_aware: "
          f"{times['gap_aware'][0]:.6f} ms a push on the card (plain "
          f"{times['gap_aware'][1]:.6f} ms), {gap_launches} one-push "
          f"launches in its online run, {gap_host_ms:.6f} ms of host time a "
          f"push there. The loop oracle: {loop_launches} one-push launches. "
          f"K1 at the MLP's {MLP_N}: a chunk of 1 push "
          f"{mlp_times[1][0]:.6f} ms, of 16 {mlp_times[16][0]:.6f} ms; "
          f"{mlp_launches} launches ({mlp_chunks} finisher chunks) in its "
          f"online run. K1 on one of {LM_SHARDS} LM shards "
          f"({QWEN_N // LM_SHARDS}): kernel {shard_k1[0]:.6f} ms, plain "
          f"{shard_k1[1]:.6f} ms, bound {shard_k1[2]:.6f} ms "
          f"({shard_k1[2] / shard_k1[0]:.1%}); {sh_launches} launches for "
          f"{sh_pushes} pushes in the sharded LM run", flush=True)
    print(f"card: {card}", flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [{
        "name": "K1 fused_apply_cohort (a chunk's server push applies + "
                "every norm, one launch)",
        "route": "triton",
        "source": "src/repro_torch/kernels/fused_update/kernel.py",
        "replaces": "src/repro/kernels/fused_update/kernel.py:91",
        "launches": launches,
        "pushes": pushes,
        "gap_aware_launches": gap_launches,
        "gap_aware_ms_per_push": times["gap_aware"][0],
        "loop_launches": loop_launches,
        "sharded_launches": sh_launches,
        "sharded_pushes": sh_pushes,
        "shard_n": QWEN_N // LM_SHARDS,
        "shard_ms": shard_k1[0],
        "shard_plain_ms": shard_k1[1],
        "shard_bound_ms": shard_k1[2],
        "mlp_launches": mlp_launches,
        "mlp_ms": {str(k): v[0] for k, v in mlp_times.items()},
        "mlp_plain_ms": {str(k): v[1] for k, v in mlp_times.items()},
        "mlp_bound_ms": {str(k): v[2] for k, v in mlp_times.items()},
        "max_abs_err": max(max_err, shard_k1[3]),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "K2 fused_update (client momentum step + sum of squares)",
        "route": "triton",
        "source": "src/repro_torch/kernels/fused_update/kernel.py",
        "replaces": "src/repro/kernels/fused_update/kernel.py:49",
        "launches": lm_launches[1],
        "max_abs_err": max(k2_err, step_err),
        "ms": k2_ms,
        "plain_ms": k2_plain,
        "bound_ms": k2_bound,
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "K3 ssd_intra_chunk (Mamba2 SSD intra-chunk step)",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:35",
        "launches": k3_launches,
        "max_abs_err": k3_err,
        "ms": k3_times[0],
        "plain_ms": k3_times[1],
        "bound_ms": k3_times[2],
        "bound_by": k3_times[3],
        "library_ms": k3_times[4],
    }, {
        "name": "online_replay (online's in-slot replay: Alg. 2's "
                "sequential lag coupling, one launch a slot)",
        "route": "cuda",
        "source": "src/repro_torch/csrc/online_replay.cu",
        "replaces": "src/repro/core/policies.py:504",
        "launches": replay["launches"],
        "max_abs_err": replay["max_abs_err"],
        "ms": replay["ms"],
        "plain_ms": replay["plain_ms"],
        "bound_ms": replay["bound_ms"],
        "bound_by": replay["bound_by"],
        "library_ms": None,
    }, {
        "name": "K4 flash_attention (causal GQA online-softmax attention)",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:38",
        "launches": k4_launches,
        "max_abs_err": k4_err,
        "ms": k4_times[0],
        "plain_ms": k4_times[1],
        "bound_ms": k4_times[2],
        "bound_by": k4_times[3],
        "library_ms": k4_times[4],
        "zoo_shapes": {arch: {
            "shape": list(K4_ZOO[arch]), "launches": zoo[arch]["k4_launches"],
            "ms": v[0], "plain_ms": v[1], "bound_ms": v[2], "bound_by": v[3],
            "library_ms": v[4], "max_abs_err": v[5]}
            for arch, v in k4_zoo.items()},
        "zoo_launches": {arch: f["k4_launches"] for arch, f in zoo.items()},
    }], "zoo_serving": zoo}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main_scan() -> int:
    """``python3 chip_smoke.py scan``: the scan-engine phase alone (the
    replay kernel's build, then (a)-(d)), a few minutes on the card against
    the whole script's ~12, for work on the engine; prints no ``ok`` line."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from repro_torch.core import Scenario, run_sweep
    from repro_torch.kernels import _cuda_build, online_replay
    print(f"card: {card_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    phase_build(_cuda_build, ("online_replay",))
    t = time.perf_counter()
    print(json.dumps(phase_scan(Scenario, run_sweep, online_replay)),
          flush=True)
    print(f"scan engine phase: {time.perf_counter() - t:.1f} s", flush=True)
    return 0


def main_zoo() -> int:
    """``python3 chip_smoke.py zoo``: K4's build, K4 at the newer
    configurations' shapes and the zoo phase alone (a few minutes), for
    work on the LM zoo; prints no ``ok`` line."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.kernels import _cuda_build
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_cuda)
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import build_model, moe as moe_mod
    print(f"card: {card_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    phase_build(_cuda_build, ("flash_attention",))
    t = time.perf_counter()
    phase_k4_zoo(flash_attention)
    zoo = phase_zoo(BatchedServer, build_model, get_config,
                    flash_attention_cuda, moe_mod)
    print(json.dumps(zoo), flush=True)
    print(f"zoo phase: {time.perf_counter() - t:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit({("scan",): main_scan, ("zoo",): main_zoo}.get(
        tuple(sys.argv[1:]), main)())
