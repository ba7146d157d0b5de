"""The paper's mechanism at LM scale: the fused momentum update (Eq. 1)
with the gradient-gap norm (Eq. 4), the counterpart of
``repro/optim/gap.py``.

``fused_momentum_gap_update(params, v, grads, *, eta, beta, lag,
kernel="auto")`` returns ``(new_params, new_v, gap)`` with
``gap = eta * (1 - beta^lag) / (1 - beta) * ||v'||_2``. In the port it is
one K2 pass over the flattened tree (``kernels/fused_update``): the Triton
kernel on CUDA tensors, its plain version on CPU tensors. The JAX module's
``fused_weighted_apply`` is ``kernels.fused_update.fused_weighted_apply``
here; ``gap_aware_scale`` and ``delay_compensate`` are still to port
(ROADMAP Queue 1 item 5).
"""
from ..kernels.fused_update import fused_momentum_gap_update

__all__ = ["fused_momentum_gap_update"]
