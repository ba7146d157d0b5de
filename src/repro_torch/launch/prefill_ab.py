"""Prefill time of two checkouts of the PyTorch port on one card, in
turns (A, B, B, A, ...), so that host and card speed, which differ from
machine to machine, fall on both alike.

    python3 src/repro_torch/launch/prefill_ab.py PARENT_DIR CHANGE_DIR \
        [--rounds 2]

Each turn is a fresh process that imports ``repro_torch`` from
``<dir>/src`` (building its CUDA kernels), builds Qwen3-0.6B under
``attention_impl="flash"`` (K4) and Mamba2-370m (K3) at full width with
random weights from seed 0, and times ``model.prefill`` of 8 prompts x
512 tokens (``synthetic_tokens``, seed 3) by CUDA events, after two
warm-up prefills: the median of ten, and the host wall of the same ten
calls (each ends in ``torch.cuda.synchronize()``). Prints one line per
turn and, last, the medians per checkout. Needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

CHILD = r'''
import dataclasses, json, sys, time
import numpy as np, torch
sys.path.insert(0, sys.argv[1] + "/src")
from repro_torch.configs import get_config
from repro_torch.data.synthetic import synthetic_tokens
from repro_torch.launch.serve import BatchedServer
out = {}
for arch in ("qwen3-0.6b", "mamba2-370m"):
    cfg = get_config(arch)
    if arch == "qwen3-0.6b":
        cfg = dataclasses.replace(cfg, attention_impl="flash")
    srv = BatchedServer(cfg, seed=0, device="cuda")
    m = srv.model
    tokens = torch.from_numpy(synthetic_tokens(8 * 512, cfg.vocab_size,
        seed=3).reshape(8, 512).astype(np.int64)).cuda()
    times, walls = [], []
    with torch.inference_mode():
        for i in range(12):
            cache = m.init_cache(8, 513, device="cuda")
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            m.prefill(srv.params, {"tokens": tokens}, cache)
            e1.record()
            torch.cuda.synchronize()
            if i >= 2:
                times.append(e0.elapsed_time(e1))
                walls.append((time.perf_counter() - t0) * 1e3)
    out[arch] = {"events_ms": sorted(times)[5], "wall_ms": sorted(walls)[5]}
    del srv, m
    torch.cuda.empty_cache()
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
    summary = {tree: {arch: {k: statistics.median(x[arch][k] for x in res)
                             for k in ("events_ms", "wall_ms")}
                      for arch in res[0]}
               for tree, res in runs.items()}
    print(json.dumps({"median_over_turns": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
