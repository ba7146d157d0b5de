"""Public wrapper of K4 — the counterpart of
``repro/kernels/flash_attention/ops.py::flash_attention``.

``kernel`` (``"auto"``, ``"cuda"`` or ``"reference"``) picks the CUDA
kernel or its plain version by the rule of ``kernels/mode.py``. The JAX
wrapper pads Sq and Sk to block multiples; the CUDA kernel masks the
ragged tail itself, so nothing is padded here. Causal attention is
defined for Sq == Sk only (row i attends keys j <= i) and raises
otherwise: the model calls it on a prefill's fresh keys, where that holds.
"""
from __future__ import annotations

from .. import mode
from .kernel import flash_attention_cuda
from .ref import attention_ref


def flash_attention(q, k, v, *, causal: bool = True, scale=None,
                    kernel: str = "auto"):
    """q: (B, H, Sq, d); k/v: (B, KV, Sk, d) -> (B, H, Sq, d) in q's
    dtype."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if mode.use_kernel(kernel, q, "cuda"):
        return flash_attention_cuda(q, k, v, causal=causal, scale=scale)
    return attention_ref(q, k, v, causal=causal, scale=scale)
