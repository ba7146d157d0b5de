"""Plain PyTorch versions of the client momentum step (K2) and the server
push apply (K1).

The oracles of the Triton kernels in ``kernel.py``: the CPU tests run
them, ``chip_smoke.py`` holds the kernels against them on the card, and
the wrappers in ``ops.py`` take them for tensors that lie on the CPU.
"""
from __future__ import annotations

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
    """
    w = float(w)
    mixed = w * new + (1.0 - w) * cur
    s = (cur - mixed) * float(inv_eta)
    v_new = beta * v + (1.0 - beta) * s
    return mixed, v_new, torch.sum(v_new * v_new)
