"""Analytic MODEL_FLOPS per (arch, shape) — the 'useful compute' yardstick,
the counterpart of ``repro/launch/flops.py``.

    train:   6 * N * D      (N = params; N_active for MoE; D = tokens)
    prefill: 2 * N * D
    decode:  2 * N * D      (D = global_batch tokens per step)

The dry run (``launch/dryrun.py``) puts it beside the FLOPs it counts in
one traced step; their ratio measures how much of the counted compute is
useful (remat recompute, the attention's quadratic work and the MoE's
dispatch push it down).
"""
from __future__ import annotations

from .shapes import SHAPES


def model_flops(cfg, shape: str) -> float:
    spec = SHAPES[shape]
    n = cfg.active_param_count() if cfg.family == "moe" else cfg.param_count()
    if spec.kind == "train":
        tokens = spec.global_batch * spec.seq_len
        return 6.0 * n * tokens
    if spec.kind == "prefill":
        tokens = spec.global_batch * spec.seq_len
        return 2.0 * n * tokens
    tokens = spec.global_batch  # one new token per sequence
    return 2.0 * n * tokens
