"""Plain PyTorch version of the server push apply (K1).

The oracle of the Triton kernel in ``kernel.py``: the CPU tests run it,
``chip_smoke.py`` holds the kernel against it on the card, and the
wrapper in ``ops.py`` takes it for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch


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
