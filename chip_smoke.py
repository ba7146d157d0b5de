"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the K1 and K2
Triton kernels from this checkout and holds each against its plain
version; drives the paper's main path (online-scheduled async LeNet-5
training) on the card and checks it against the immediate baseline and a
CPU run; then drives the async federated LM trainer at Qwen3-0.6B's full
width (596,049,920 parameters, K2 on every island step, K1 on every push),
holds one full-width train step's K2 epilogue against the plain version
and profiles a few steps.

    python3 chip_smoke.py

Needs a CUDA device (exits non-zero without one) and nothing but this
repository's ``src/``. Every phase raises on failure; nothing is caught.
The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``,
the line before it the ``{"kernels": [...]}`` record.
"""
from __future__ import annotations

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


def phase_k1(fused_apply_flat, bound_ms):
    """K1 (Triton) against its plain version on the same CUDA tensors, at
    the reference's bounds (tests/test_kernels.py): mixed at rtol 1e-6 /
    atol 1e-6; v' at rtol 1e-6 / atol 1e-6 * (max|v'| + 1), because
    (cur - mixed) * inv_eta cancels; Sum(v'^2) at rtol 1e-5."""
    max_err = 0.0
    for n in K1_SIZES:
        cur, v, new = k1_inputs(n, n, "cuda")
        for w in K1_WEIGHTS:
            for beta, eta in K1_BETA_ETA:
                inv_eta = 1.0 / eta
                m, v2, sq = fused_apply_flat(cur, v, new, w, inv_eta, beta,
                                             kernel="triton")
                mr, vr, sqr = fused_apply_flat(cur, v, new, w, inv_eta,
                                               beta, kernel="reference")
                torch.cuda.synchronize()
                m, v2, mr, vr = (x.cpu().numpy() for x in (m, v2, mr, vr))
                np.testing.assert_allclose(m, mr, rtol=1e-6, atol=1e-6)
                v_scale = float(np.max(np.abs(vr), initial=0.0)) + 1.0
                np.testing.assert_allclose(v2, vr, rtol=1e-6,
                                           atol=1e-6 * v_scale)
                np.testing.assert_allclose(float(sq), float(sqr),
                                           rtol=1e-5, atol=1e-10)
                if n:
                    max_err = max(max_err, float(np.max(np.abs(m - mr))),
                                  float(np.max(np.abs(v2 - vr))))
        print(f"K1 n={n}: {len(K1_WEIGHTS) * len(K1_BETA_ETA)} cases "
              f"match the plain version", flush=True)
    times = {}
    for n in (LENET_N, 2 ** 24 + 17, QWEN_N):
        cur, v, new = (k1_inputs(n, 1, "cuda") if n < QWEN_N
                       else dev_inputs(n, 1))
        iters = {LENET_N: 2000, QWEN_N: 20}.get(n, 100)
        ms = time_ms(lambda: fused_apply_flat(cur, v, new, 1.0, 100.0, 0.9,
                                              kernel="triton"), iters)
        plain = time_ms(lambda: fused_apply_flat(cur, v, new, 1.0, 100.0,
                                                 0.9, kernel="reference"),
                        iters)
        times[n] = (ms, plain, bound_ms(n))
        print(f"K1 n={n}: kernel {ms:.6f} ms, plain {plain:.6f} ms, "
              f"bound {bound_ms(n):.6f} ms (20 B/element at 3.35 TB/s)",
              flush=True)
        del cur, v, new
    torch.cuda.empty_cache()
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

    setattr(obj, name, timed)


def run_main(Scenario, policy, device, counter):
    """One run of the main path; returns (result, wall_s, launches). Prints
    the host seconds spent in the backend's entry points: the cohort
    finish (local epochs + K1 pushes), the evaluation, and ``v_norm``, the
    host sync the online policy makes every slot that has waiting users."""
    sim = Scenario(policy=policy, ml="lenet", ml_kwargs=dict(device=device),
                   **MAIN).build()
    stats = {}
    for name in ("finish_async_batch", "evaluate", "v_norm"):
        _time_calls(sim.ml_backend, name, stats)
    if device == "cuda":
        torch.cuda.synchronize()
    counter.launches = 0
    t0 = time.perf_counter()
    res = sim.run()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counter.launches
    print(f"{policy} on {device}: energy {res.energy_j!r} J, updates "
          f"{res.updates}, pushes {len(res.push_log)}, K1 launches "
          f"{launches}, co-run fraction {res.corun_fraction!r}, mean_H "
          f"{res.mean_H!r}, accuracy {res.accuracy}, wall {wall!r} s, "
          f"{res.updates / wall!r} updates/s; host seconds (calls): "
          + ", ".join(f"{k} {v[1]!r} ({v[0]})" for k, v in stats.items()),
          flush=True)
    assert np.isfinite(res.energy_j) and res.energy_j > 0
    assert all(0.0 <= a <= 1.0 for _, a in res.accuracy)
    return res, wall, launches


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
    print(f"profile: online, horizon {horizon_s} s, {res.updates} updates, "
          f"wall {wall!r} s (profiled), device busy {busy_s!r} s, idle "
          f"share {1.0 - busy_s / wall!r}, device-side kernel launches "
          f"{sum(r[2] for r in rows)}", flush=True)
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
    k1.launches = k2.launches = 0
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
    assert launches[0] == pushes, (launches[0], pushes)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    from repro_torch.core import AsyncParameterServer, Scenario
    from repro_torch.kernels.fused_update import (fused_apply_flat,
                                                  fused_apply_triton,
                                                  fused_update_flat,
                                                  fused_update_triton)
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.kernels.fused_update.kernel import (BYTES_PER_ELEMENT,
                                                         HBM_BYTES_PER_S)
    import triton

    def bound_ms(n):    # 3 f32 reads + 2 f32 writes per element + sumsq
        # (K1 and K2 alike)
        return (BYTES_PER_ELEMENT * n + 4) / HBM_BYTES_PER_S * 1e3

    # ---- 1. environment --------------------------------------------------
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, triton {triton.__version__}, CUDA "
          f"{torch.version.cuda}, device {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}; cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}, cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)

    # ---- 2. K1 against its plain version ---------------------------------
    t = time.perf_counter()
    max_err, times = phase_k1(fused_apply_flat, bound_ms)
    print(f"K1 phase: {time.perf_counter() - t:.1f} s", flush=True)

    # ---- 3. the main path on the card ------------------------------------
    t = time.perf_counter()
    online, wall, launches = run_main(Scenario, "online", "cuda",
                                      fused_apply_triton)
    assert online.updates > 0, "the online policy made no update"
    assert launches == len(online.push_log) == online.updates, \
        (launches, len(online.push_log), online.updates)
    print(f"main path phase: {time.perf_counter() - t:.1f} s", flush=True)

    t = time.perf_counter()
    profile_main(Scenario, horizon_s=1200)
    print(f"profile phase: {time.perf_counter() - t:.1f} s", flush=True)

    # ---- 4. the immediate baseline ----------------------------------------
    t = time.perf_counter()
    immediate, _, imm_launches = run_main(Scenario, "immediate", "cuda",
                                          fused_apply_triton)
    assert imm_launches == immediate.updates > 0
    saving = 1.0 - online.energy_j / immediate.energy_j
    print(f"online vs immediate: energy saving {saving!r}", flush=True)
    print(f"immediate phase: {time.perf_counter() - t:.1f} s", flush=True)

    # ---- 5. the same online run on the CPU --------------------------------
    t = time.perf_counter()
    cpu, _, cpu_launches = run_main(Scenario, "online", "cpu",
                                    fused_apply_triton)
    assert cpu_launches == 0, "a CPU run launched the CUDA kernel"
    if online.mean_H == 0.0 and cpu.mean_H == 0.0:
        assert schedule_digest(cpu.push_log) == \
            schedule_digest(online.push_log), "CPU/CUDA schedules differ"
        assert [s for s, _ in cpu.accuracy] == \
            [s for s, _ in online.accuracy]
        np.testing.assert_allclose([a for _, a in online.accuracy],
                                   [a for _, a in cpu.accuracy], atol=0.03)
        print(f"CPU run: same schedule digest "
              f"{schedule_digest(online.push_log)[:16]}, accuracy within "
              f"0.03", flush=True)
    else:
        print(f"CPU run: mean_H {cpu.mean_H!r} / {online.mean_H!r} > 0, "
              "schedules may part ways; digest not compared", flush=True)
    print(f"CPU phase: {time.perf_counter() - t:.1f} s", flush=True)

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

    # ---- 8. the kernels record ---------------------------------------------
    ms, plain_ms, b_ms = times[LENET_N]
    k2_ms, k2_plain, k2_bound, _ = k2_times[QWEN_N]
    print(f"K1 at the LM's {QWEN_N} parameters: kernel "
          f"{times[QWEN_N][0]:.6f} ms, plain {times[QWEN_N][1]:.6f} ms, "
          f"bound {times[QWEN_N][2]:.6f} ms; {lm_launches[0]} launches in "
          f"the LM run", flush=True)
    print(f"card: {card}", flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [{
        "name": "K1 fused_apply (server push apply + sum of squares)",
        "route": "triton",
        "source": "src/repro_torch/kernels/fused_update/kernel.py",
        "replaces": "src/repro/kernels/fused_update/kernel.py:91",
        "launches": launches,
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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
