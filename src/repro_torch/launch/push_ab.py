"""The push side of a LeNet finish, and the LeNet main path's wall, for
two checkouts of the PyTorch port on one card, in turns (A, B, B, A, ...),
so that host and card speed, which differ from machine to machine, fall on
both alike.

    python3 src/repro_torch/launch/push_ab.py PARENT_DIR CHANGE_DIR \
        [--rounds 2]

Each turn is a fresh process that imports ``repro_torch`` from
``<dir>/src``. It times the push side of one finisher chunk at LeNet-5's
width (62,006 parameters) for k = 1 and k = 16 pushes under the
``replace`` rule, as that checkout's ``core/realml.py`` runs it — a
checkout with ``fused_apply_cohort`` makes one K1 launch a chunk, one
without it a K1 launch a push with the norms chained through
``torch.sum``/``torch.sqrt`` — each repetition ending in the
device-to-host copy of the chunk's pre-push norms (host clock, median of
300 after warm-up), and counts the chunk's device operations (kernels,
copies and fills) with ``torch.profiler``. Then it runs the main path,
``Scenario(policy="online", ml="lenet", n_users=25, horizon_s=3600,
V=5.0, app_arrival_p=0.004, seed=0)``, once after a 600 s warm-up run,
and reports its wall and the host seconds in ``finish_async_batch``.
Prints one line per turn and, last, the medians per checkout. Needs a
CUDA device.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

CHILD = r'''
import json, statistics, sys, time
import numpy as np, torch
sys.path.insert(0, sys.argv[1] + "/src")
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from repro_torch.core import Scenario
from repro_torch.kernels import fused_update as fu

N, ETA, BETA = 62006, 0.01, 0.9
INV_ETA = 1.0 / ETA
cohort = hasattr(fu, "fused_apply_cohort")


def push_side(p, v, trained, weights):
    """One chunk's pushes and the copy of its pre-push norms, as the
    checkout's finish runs them."""
    k = trained.shape[0]
    if cohort:
        w = None if np.all(weights == 1.0) else torch.tensor(
            weights, dtype=torch.float32, device=p.device)
        p, v, _, norms = fu.fused_apply_cohort(p, v, trained.contiguous(),
                                               w, INV_ETA, BETA)
        v_norm = norms[k]
        vn = norms[:k].cpu().numpy().astype(np.float64)
    else:
        vnorms = []
        sq = torch.sum(v * v)
        for j in range(k):
            vnorms.append(torch.sqrt(sq))
            p, v, sq = fu.fused_apply_flat(p, v, trained[j], weights[j],
                                           INV_ETA, BETA)
        v_norm = torch.sqrt(sq)
        vn = torch.stack(vnorms).cpu().numpy().astype(np.float64)
    return p, v, v_norm, vn


out = {"cohort_kernel": cohort}
gen = torch.Generator(device="cuda").manual_seed(0)
p0, v0 = (torch.randn(N, generator=gen, device="cuda") for _ in range(2))
for k in (1, 16):
    trained = torch.randn((k, N), generator=gen, device="cuda")
    weights = np.ones(k)
    for _ in range(20):
        push_side(p0, v0, trained, weights)
    walls = []
    for _ in range(300):
        t0 = time.perf_counter()
        push_side(p0, v0, trained, weights)
        walls.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            push_side(p0, v0, trained, weights)
        torch.cuda.synchronize()
    ops = sum(e.count for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA) / 10
    out[f"k{k}"] = {"push_side_ms": statistics.median(walls),
                    "device_ops": ops}

kw = dict(policy="online", ml="lenet", n_users=25, V=5.0,
          app_arrival_p=0.004, seed=0, ml_kwargs=dict(device="cuda"))
Scenario(horizon_s=600, **kw).run()
sim = Scenario(horizon_s=3600, **kw).build()
backend = sim.ml_backend
finish = backend.finish_async_batch
spent = [0.0]


def timed(*a, **k):
    t0 = time.perf_counter()
    r = finish(*a, **k)
    spent[0] += time.perf_counter() - t0
    return r


backend.finish_async_batch = timed
torch.cuda.synchronize()
t0 = time.perf_counter()
res = sim.run()
torch.cuda.synchronize()
out["lenet"] = {"wall_s": time.perf_counter() - t0, "updates": res.updates,
                "finish_s": spent[0], "energy_j": res.energy_j}
print(json.dumps(out))
'''


def turn(tree):
    r = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(tree)],
                       capture_output=True, text=True, timeout=900)
    if r.returncode:
        raise RuntimeError(f"{tree}: exit {r.returncode}\n{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


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
    summary = {tree: {part: {key: statistics.median(x[part][key] for x in res)
                             for key in res[0][part]}
                      for part in ("k1", "k16", "lenet")}
               for tree, res in runs.items()}
    print(json.dumps({"median_over_turns": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
