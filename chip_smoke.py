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
im2col-and-matmul convolutions against cuDNN's); drives the
async federated LM trainer at Qwen3-0.6B's full width (596,049,920
parameters, K2 on every island step, K1 on every push), holds one
full-width train step's K2 epilogue against the plain version and
profiles a few steps; then serves Qwen3-0.6B (attention_impl="flash": K4
on every layer's prefill) and Mamba2-370m (K3 on every layer's prefill)
at full width through ``launch.serve.BatchedServer``, compares each
kernel route's prefill logits with the plain route's, and profiles one
prefill and a few decode steps.

    python3 chip_smoke.py

Needs a CUDA device and the CUDA toolkit (exits non-zero without a
device) and nothing but this repository's ``src/``. Every phase raises on
failure; nothing is caught. The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``,
the line before it the ``{"kernels": [...]}`` record.
"""
from __future__ import annotations

import contextlib
import dataclasses
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
# the Table II devices, one simulated hour
MAIN = dict(n_users=25, horizon_s=3600, V=5.0, app_arrival_p=0.004, seed=0)
K1_SIZES = (0, 1, 1029, 62006, 2 ** 24 + 17)
K1_COHORT_K = (1, 2, 5, 16)     # pushes a launch: 16 is a full LeNet chunk
K1_WEIGHTS = (1.0, 0.6, 0.05)
K1_BETA_ETA = ((0.9, 0.01), (0.0, 0.5), (0.99, 1e-4))
LENET_N = 62006
# Qwen3-0.6B at full width (configs/qwen3_0_6b.py), and its smoke config
QWEN_N = 596_049_920
K2_SIZES = (0, 1, 1029, 82304, QWEN_N, 2 ** 24 + 17)
K2_ETA_BETA = ((0.01, 0.9), (0.05, 0.9), (0.1, 0.0))
# the LM trainer's defaults (4 islands, batch 8, seq 64, 4 local steps),
# 120 scheduler slots with an evaluation every 60
LM_RUN = dict(slots=120, eval_every=60, app_arrival_p=0.05)
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


def _time_calls(obj, name, stats):
    """Replace ``obj.name`` with a wrapper that counts its calls and their
    host seconds into ``stats[name]``."""
    fn = getattr(obj, name)
    stats[name] = [0, 0.0]

    def timed(*a, **k):
        t = time.perf_counter()
        out = fn(*a, **k)
        stats[name][0] += 1
        stats[name][1] += time.perf_counter() - t
        return out

    timed.__wrapped__ = fn
    setattr(obj, name, timed)


def run_main(Scenario, policy, device, counter, aggregation="replace",
             kernel="auto", label="", **over):
    """One run of the main path (``MAIN``, with ``over`` replacing its
    entries); returns (result, wall_s, launches, pushes, chunks, stats,
    the simulator).
    Prints the host seconds spent in the backend's entry points: the
    cohort finish (local epochs + K1 pushes; ``local_train_batch`` under
    sync), the evaluation, and ``v_norm``, the host sync the online policy
    makes every slot that has waiting users; and, inside the finish, in
    the K1 wrapper calls (the push side: one a chunk of at most
    COHORT_CHUNK finishers, one a push under gap_aware) and, under
    gap_aware, in ``gap_aware_pushes`` (the weights computed on the card,
    then the one-push launches)."""
    from repro_torch.core import realml
    sim = Scenario(policy=policy, ml="lenet", aggregation=aggregation,
                   kernel=kernel, ml_kwargs=dict(device=device),
                   **dict(MAIN, **over)).build()
    backend = sim.ml_backend
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
    label = (f"{policy} ({aggregation}, kernel={kernel}{label}"
             f"{''.join(f', {k}={v}' for k, v in over.items())})")
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
    its horizon cut to 900 s, twice through the model's route (equal push
    logs and accuracy) and twice through cuDNN's default algorithms (the
    spread, and the wall of each)."""
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
                             horizon_s=900)
                    for _ in range(2)]
        (r1, w1, *_), (r2, w2, *_) = runs
        same = list(r1.push_log) == list(r2.push_log) and \
            r1.accuracy == r2.accuracy
        print(f"repeat, immediate 900 s twice, {CONV_ROUTES[i]}: "
              f"{'equal' if same else 'DIFFER'}; accuracy {r1.accuracy} / "
              f"{r2.accuracy}; walls {w1!r} / {w2!r} s", flush=True)
        if i == 0:
            assert same, "two card runs of the model's route differ"


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
    full width. Counts K1/K2 launches over exactly this run, the pushes
    and local epochs (with their host seconds: a push's ``float`` of the
    new momentum norm is the run's per-push host sync, and it waits for
    the island's queued epoch), the wall time and the peak memory."""
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-0.6b")
    assert cfg.param_count() == QWEN_N, cfg.param_count()
    icfg = train.IslandConfig(**LM_RUN)
    stats = {}
    originals = {(AsyncParameterServer, "push"): AsyncParameterServer.push,
                 (train.Island, "local_epoch"): train.Island.local_epoch}
    for obj, name in originals:
        _time_calls(obj, name, stats)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.launches = k1.pushes = k2.launches = 0
    t0 = time.perf_counter()
    out = train.run(cfg, icfg, device="cuda",
                    log=lambda m: print(f"LM {m}", flush=True))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (k1.launches, k2.launches)
    for (obj, name), fn in originals.items():
        setattr(obj, name, fn)
    peak = torch.cuda.max_memory_allocated()
    pushes, push_s = stats["push"]
    epochs, epoch_s = stats["local_epoch"]
    losses = [l for _, l, _ in out["history"]] + [out["final_loss"]]
    steps = launches[1]
    train_s = push_s + epoch_s
    print(f"LM qwen3-0.6b ({cfg.param_count()} parameters, {icfg.n_islands} "
          f"islands, batch {icfg.batch}, seq {icfg.seq}, {icfg.local_steps} "
          f"local steps, {icfg.slots} slots): updates {out['updates']}, "
          f"pushes {pushes}, local epochs {epochs}, steps {steps}, K1 "
          f"launches {launches[0]}, K2 launches {launches[1]}; eval loss "
          f"first {losses[0]!r} last {losses[-1]!r}; energy "
          f"{out['energy_j']!r} J; wall {wall!r} s (setup included); "
          f"host seconds in local_epoch {epoch_s!r} and push {push_s!r} "
          f"({pushes} host syncs, one per push); {steps / train_s!r} "
          f"steps/s and {steps * icfg.batch * icfg.seq / train_s!r} tokens/s "
          f"over those seconds, {steps / wall!r} steps/s over the wall; peak "
          f"memory {peak / 2 ** 30!r} GiB", flush=True)
    assert out["updates"] > 0, "the LM trainer made no update"
    assert out["updates"] == pushes, (out["updates"], pushes)
    assert all(np.isfinite(l) for l in losses), losses
    assert launches[0] == pushes == k1.pushes, (launches[0], pushes,
                                                 k1.pushes)
    assert launches[1] == icfg.local_steps * epochs, (launches[1], epochs)
    return out["params"], cfg, launches


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


def randn(shape, gen, dtype=torch.float32, scale=1.0):
    return (scale * torch.randn(shape, generator=gen, device="cuda")).to(
        dtype)


def phase_build(cuda_build):
    """Build the CUDA C++ kernels (one nvcc per source, started together)
    and print what ptxas said about registers, shared memory and spills."""
    built = cuda_build.build_all()
    for name, (path, secs) in built.items():
        print(f"build {name}: {path.name} ready after {secs:.1f} s",
              flush=True)
        for line in cuda_build.ptxas_report(name).splitlines():
            if "Used" in line or "spill" in line or "Compiling" in line:
                print(f"ptxas {name}: {line.strip()[:150]}", flush=True)


def phase_k4(flash_attention):
    """K4 (CUDA C++) against its plain version on the same CUDA tensors:
    the TestFlashAttention shapes and a ragged S, causal and not, at the
    reference's bounds (2e-5 in f32: the CUDA-core form; 2e-2 in bf16: the
    wgmma form, which rounds P to bf16), then the serving shape in bf16
    with its times: the kernel, the plain version, the bound and torch's
    SDPA (one call computing the same function; the port never calls
    it)."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(4)
    max_err = 0.0
    for B, H, KV, S, d in K4_SHAPES + (K4_SERVE,):
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
    B, H, KV, S, d = K4_SERVE
    q = randn((B, H, S, d), gen, torch.bfloat16)
    k, v = (randn((B, KV, S, d), gen, torch.bfloat16) for _ in "kv")
    ms = time_ms(lambda: flash_attention(q, k, v, kernel="cuda"), 50)
    plain = time_ms(lambda: flash_attention(q, k, v, kernel="reference"), 10)
    sdpa = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 50)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())   # q, o, k, v
    flops = 4 * B * H * d * S * (S + 1) // 2     # QK^T and PV, j <= i only
    bound = max(nbytes / HBM_BPS, flops / BF16_FLOPS) * 1e3
    print(f"K4 serving shape {K4_SERVE} bf16 causal: kernel {ms:.6f} ms "
          f"(the first, CUDA-core form: {FIRST_FORM_MS['K4']} ms), plain "
          f"{plain:.6f} ms, SDPA {sdpa:.6f} ms, bound {bound:.6f} ms "
          f"({nbytes} B at 3.35 TB/s; {flops} FLOP take "
          f"{flops / BF16_FLOPS * 1e3:.6f} ms at the bf16 tensor-core peak, "
          f"{flops / F32_FLOPS * 1e3:.6f} ms on the f32 CUDA cores)",
          flush=True)
    return max_err, (ms, plain, bound, "bytes" if nbytes / HBM_BPS >=
                     flops / BF16_FLOPS else "operations", sdpa)


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


def run_serve(BatchedServer, build_model, cfg, params, counter, per_layer):
    """``BatchedServer.generate`` of SERVE_BATCH prompts of SERVE_PROMPT
    tokens and SERVE_GEN new tokens on the card (after a short warm-up
    generate), counting the kernel's launches over exactly that call; the
    prefill and each decode step timed by CUDA events around the model's
    calls; then the kernel-vs-plain prefill comparison and a profile of
    one prefill and of a few decode steps. Returns (server, prompts,
    tokens, launches)."""
    srv = BatchedServer(cfg, params=params, device="cuda")
    prompts = serve_prompts(cfg)
    srv.generate(prompts[:, :64], 2)                      # warm-up
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
    assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
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
    from repro_torch.core import AsyncParameterServer, Scenario
    from repro_torch.kernels import fused_update
    from repro_torch.kernels.fused_update import (fused_apply_triton,
                                                  fused_update_flat,
                                                  fused_update_triton)
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.kernels.fused_update.kernel import (
        BYTES_PER_ELEMENT, HBM_BYTES_PER_S, cohort_bytes, ticket_counter)
    from repro_torch.kernels import _cuda_build, ssd_scan
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_cuda)
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import build_model, ssm as ssm_model
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
    card = phase_schedules(Scenario, fused_apply_triton, online)
    print(f"schedules phase: {time.perf_counter() - t:.1f} s", flush=True)

    # ---- 5. online, offline and sync again on the CPU ---------------------
    t = time.perf_counter()
    phase_cpu(Scenario, fused_apply_triton, card)
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

    # ---- 6. K2 against its plain version ---------------------------------
    t = time.perf_counter()
    k2_err, k2_times = phase_k2(fused_update_flat, bound_ms)
    print(f"K2 phase: {time.perf_counter() - t:.1f} s", flush=True)

    # ---- 7. the LM path on the card: Qwen3-0.6B at full width --------------
    t = time.perf_counter()
    params, cfg, lm_launches = run_lm(train, AsyncParameterServer,
                                      fused_apply_triton, fused_update_triton)
    print(f"LM run phase: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    step_err = phase_lm_step(params, cfg, make_train_step,
                             fused_update_triton)
    profile_lm_steps(params, cfg, make_train_step)
    print(f"LM step phase: {time.perf_counter() - t:.1f} s", flush=True)

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
          f"push there", flush=True)
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
        "max_abs_err": max_err,
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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
