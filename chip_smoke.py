"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the K1 Triton
kernel from this checkout, holds it against its plain version, drives the
paper's main path (online-scheduled async LeNet-5 training) on the card,
and checks the result against the immediate baseline and a CPU run.

    python3 chip_smoke.py

Needs a CUDA device (exits non-zero without one) and nothing but this
repository's ``src/``. Every phase raises on failure; nothing is caught.
The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``,
the line before it the ``{"kernels": [...]}`` record.
"""
from __future__ import annotations

import hashlib
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
    for n in (LENET_N, 2 ** 24 + 17):
        cur, v, new = k1_inputs(n, 1, "cuda")
        iters = 2000 if n == LENET_N else 100
        ms = time_ms(lambda: fused_apply_flat(cur, v, new, 1.0, 100.0, 0.9,
                                              kernel="triton"), iters)
        plain = time_ms(lambda: fused_apply_flat(cur, v, new, 1.0, 100.0,
                                                 0.9, kernel="reference"),
                        iters)
        times[n] = (ms, plain, bound_ms(n))
        print(f"K1 n={n}: kernel {ms:.6f} ms, plain {plain:.6f} ms, "
              f"bound {bound_ms(n):.6f} ms (20 B/element at 3.35 TB/s)",
              flush=True)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core import Scenario
    from repro_torch.kernels.fused_update import (fused_apply_flat,
                                                  fused_apply_triton)
    from repro_torch.kernels.fused_update.kernel import (BYTES_PER_ELEMENT,
                                                         HBM_BYTES_PER_S)
    import triton

    def bound_ms(n):    # 3 f32 reads + 2 f32 writes per element + sumsq
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
    online, wall, launches = run_main(Scenario, "online", "cuda",
                                      fused_apply_triton)
    assert online.updates > 0, "the online policy made no update"
    assert launches == len(online.push_log) == online.updates, \
        (launches, len(online.push_log), online.updates)

    profile_main(Scenario, horizon_s=1200)

    # ---- 4. the immediate baseline ----------------------------------------
    immediate, _, imm_launches = run_main(Scenario, "immediate", "cuda",
                                          fused_apply_triton)
    assert imm_launches == immediate.updates > 0
    saving = 1.0 - online.energy_j / immediate.energy_j
    print(f"online vs immediate: energy saving {saving!r}", flush=True)

    # ---- 5. the same online run on the CPU --------------------------------
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

    # ---- 6. the kernels record -------------------------------------------
    ms, plain_ms, b_ms = times[LENET_N]
    print(f"card: {card}", flush=True)
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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
