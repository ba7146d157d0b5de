"""Online's replay kernel, and the scan engine's fleet run around it, for
two checkouts of the PyTorch port on one card, in turns (A, B, B, A, ...),
so that host and card speed, which differ from machine to machine, fall on
both alike.

    python3 src/repro_torch/launch/replay_ab.py PARENT_DIR CHANGE_DIR \
        [--rounds 2]

Each turn is a fresh process that imports ``repro_torch`` from
``<dir>/src`` (building its replay kernel). It times that checkout's
``online_replay_cuda`` on ``chip_smoke.py``'s timed inputs (100,000
users, H = 37.5, seed 7; B = 1 and 16) by CUDA events over 50 launches
queued behind a sleeping kernel (device time, not the host's cost of a
call); then, after an 8-slot warm-up, runs ``Scenario(policy="online",
engine="jax", jax_chunk=0, n_users=100_000, horizon_s=300, seed=0)`` at
the defaults and at L_b = 2.0 (host wall to a synchronize, the schedule's
digest over (t, user, lag, corun)), and the L_b = 2.0 run of 8 and of
300 slots once more under ``torch.profiler``: device kernels a slot,
device busy seconds and the replay kernel's device seconds. Prints one
line per turn and, last, the medians per checkout. Needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

CHILD = r'''
import hashlib, json, sys, time
import numpy as np, torch
sys.path.insert(0, sys.argv[1] + "/src")
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from repro_torch.core import Scenario
from repro_torch.kernels.online_replay import online_replay_cuda

N, T = 100_000, 300


def inputs(B, n, H, seed):      # chip_smoke.replay_inputs
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
    k = rng.integers(0, n + 1, (B, n))
    gap_idle = np.where(tie, np.take_along_axis(gap_vec, k, 1), gap_idle)
    ulp = rng.random((B, n)) < 0.1
    base = np.where(ulp, np.nextafter(rhs, rng.choice([-np.inf, np.inf],
                                                      (B, n))), base)
    cuda = lambda a, dt: torch.as_tensor(a).to("cuda", dt)
    return (cuda(waiting, torch.bool), cuda(base, torch.float64),
            cuda(rhs, torch.float64), cuda(gap_idle, torch.float64),
            cuda(gap_vec, torch.float64),
            cuda(np.full(B, float(H)), torch.float64))


def device_ms(fn, iters):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def digest(log):
    return hashlib.sha256(json.dumps(
        [(e["t"], e["user"], e["lag"], e["corun"]) for e in log]
    ).encode()).hexdigest()[:16]


def build(slots, **over):
    return Scenario(policy="online", engine="jax", jax_chunk=0, n_users=N,
                    horizon_s=slots, seed=0, **over).build(device="cuda")


out = {}
for B in (1, 16):
    args = inputs(B, N, 37.5, 7)
    out[f"replay_ms_B{B}"] = device_ms(lambda: online_replay_cuda(*args), 50)
build(8, L_b=2.0).run()
for key, over in (("defaults", {}), ("L_b=2.0", {"L_b": 2.0})):
    sim = build(T, **over)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sim.run()
    torch.cuda.synchronize()
    out[key] = {"wall_s": time.perf_counter() - t0,
                "digest": digest(res.push_log), "updates": res.updates}
for slots in (8, T):
    sim = build(slots, L_b=2.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim.run()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) * 1e-6
    replay = sum(e.self_device_time_total for e in rows
                 if "online_replay" in e.key) * 1e-6
    out[f"profile_{slots}"] = {
        "kernels_a_slot": sum(e.count for e in rows) / slots,
        "busy_s": busy, "replay_s": replay,
        "replay_share_of_busy": replay / busy}
print(json.dumps(out))
'''

KEYS = (("replay_ms_B1",), ("replay_ms_B16",), ("defaults", "wall_s"),
        ("L_b=2.0", "wall_s"), ("profile_300", "busy_s"),
        ("profile_300", "replay_s"), ("profile_300", "kernels_a_slot"),
        ("profile_8", "kernels_a_slot"), ("profile_8", "busy_s"),
        ("profile_8", "replay_s"))


def turn(tree):
    r = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(tree)],
                       capture_output=True, text=True, timeout=900)
    if r.returncode:
        raise RuntimeError(f"{tree}: exit {r.returncode}\n{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def pick(res, key):
    for k in key:
        res = res[k]
    return res


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--rounds", type=int, default=2)
    a = ap.parse_args()
    runs = {a.parent: [], a.change: []}
    for r in range(a.rounds):
        order = (a.parent, a.change) if r % 2 == 0 else (a.change, a.parent)
        for tree in order:
            res = turn(tree)
            runs[tree].append(res)
            print(f"{tree}: {json.dumps(res)}", flush=True)
    summary = {tree: {"/".join(k): statistics.median(pick(x, k) for x in res)
                      for k in KEYS}
               for tree, res in runs.items()}
    print(json.dumps({"median_over_turns": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
