"""The paper's mechanism at LM scale: the fused momentum update (Eq. 1)
with the gradient-gap norm (Eq. 4), gap-aware scaling [31] and delay
compensation [10] — the counterpart of ``repro/optim/gap.py``.

``fused_momentum_gap_update(params, v, grads, *, eta, beta, lag,
kernel="auto")`` returns ``(new_params, new_v, gap)`` with
``gap = eta * (1 - beta^lag) / (1 - beta) * ||v'||_2``. In the port it is
one K2 pass over the flattened tree (``kernels/fused_update``): the Triton
kernel on CUDA tensors, its plain version on CPU tensors. The JAX module's
``fused_weighted_apply`` (one K1 pass) is
``kernels.fused_update.fused_weighted_apply``, re-exported here.
"""
from __future__ import annotations

from typing import Any

import torch

from ..kernels.fused_update import (fused_momentum_gap_update,
                                    fused_weighted_apply)
from ..kernels.fused_update.ops import tree_map

__all__ = ["fused_momentum_gap_update", "fused_weighted_apply",
           "gap_aware_scale", "delay_compensate"]


def gap_aware_scale(gap, gap_ref):
    """Gap-aware staleness dampening [31]: scale update by 1/(1+gap/ref).
    Numbers are taken as f32 tensors, as the JAX function takes them."""
    gap = torch.as_tensor(gap, dtype=None if torch.is_tensor(gap)
                          else torch.float32)
    gap_ref = torch.as_tensor(gap_ref, dtype=gap.dtype, device=gap.device)
    return 1.0 / (1.0 + gap / torch.clamp(gap_ref, min=1e-9))


def delay_compensate(grads: Any, params_now: Any, params_then: Any,
                     lambda_dc: float = 0.5):
    """DC-ASGD [10]: g_dc = g + lambda * g*g*(theta_now - theta_then)
    (diagonal Hessian approximation via gradient outer-product)."""
    return tree_map(
        lambda g, pn, pt: g + lambda_dc * g * g * (pn - pt).to(g.dtype),
        grads, params_now, params_then)
