"""Plain PyTorch versions of the client momentum step (K2) and the server
push apply (K1, one push and a chunk of pushes).

The oracles of the Triton kernels in ``kernel.py``: the CPU tests run
them, ``chip_smoke.py`` holds the kernels against them on the card, and
the wrappers in ``ops.py`` take them for tensors that lie on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch


def fused_update_flat_ref(theta, v, g, eta, beta):
    """theta/v/g: f32 tensors of one shape; the client step of Eq. 1 with
    the Eq. 4 norm (``repro.optim.gap.fused_momentum_gap_update``).

    Returns (theta', v', sumsq), sumsq a 0-d f32 tensor:
        v'     = beta * v + (1 - beta) * g
        theta' = theta - eta * v'
        sumsq  = Sum(v'^2)
    """
    v_new = beta * v + (1.0 - beta) * g
    return theta - eta * v_new, v_new, torch.sum(v_new * v_new)


def fused_apply_flat_ref(cur, v, new, w, inv_eta, beta):
    """cur/v/new: f32 tensors of one shape; the server push-apply contract
    (``AsyncParameterServer.push``).

    Returns (mixed, v', sumsq), sumsq a 0-d f32 tensor:
        mixed = w * new + (1 - w) * cur
        s     = (cur - mixed) * inv_eta
        v'    = beta * v + (1 - beta) * s
        sumsq = Sum(v'^2)
    with the scalars, 1 - w and 1 - beta taken in f32 as the kernel (and
    the TPU kernel) takes them: where v' cancels, 1 - beta rounded from
    f64 instead moves it past the kernel's bound.
    """
    w, inv_eta, beta = (np.float32(x) for x in (w, inv_eta, beta))
    one = np.float32(1.0)
    mixed = float(w) * new + float(one - w) * cur
    s = (cur - mixed) * float(inv_eta)
    v_new = float(beta) * v + float(one - beta) * s
    return mixed, v_new, torch.sum(v_new * v_new)


def fused_apply_cohort_ref(cur, v, trained, weights, inv_eta, beta):
    """The k pushes of a chunk (``trained`` ``(k, N)``, ``weights`` a
    ``(k,)`` tensor or None for weights of 1) applied in order: k chained
    ``fused_apply_flat_ref`` calls.

    Returns (p', v', sumsq, norms), sumsq ``(k + 1,)`` f32: the entry
    momentum's Sum(v^2), then each push's post-push sum; norms their
    square roots (norm j is push j's pre-push norm, norm k the final)."""
    sums = [torch.sum(v * v)]
    for j in range(trained.shape[0]):
        w = 1.0 if weights is None else float(weights[j])
        cur, v, sq = fused_apply_flat_ref(cur, v, trained[j], w, inv_eta,
                                          beta)
        sums.append(sq)
    sums = torch.stack(sums)
    return cur, v, sums, torch.sqrt(sums)
