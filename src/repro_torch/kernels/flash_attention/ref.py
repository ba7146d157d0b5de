"""The plain PyTorch version of K4 — the counterpart of
``repro/kernels/flash_attention/ref.py::attention_ref``.

The oracle of the CUDA kernel in ``csrc/flash_attention.cu``: the CPU
tests run it, ``chip_smoke.py`` holds the kernel against it on the card,
and ``ops.flash_attention`` takes it for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True, scale=None):
    """q: (B, H, Sq, d); k/v: (B, KV, Sk, d); H % KV == 0; query head h
    reads KV head h * KV // H. Scores, softmax and the weighted sum in f32,
    the output cast back to q's dtype.

    Causal masking is row i attends keys j <= i and is defined only for
    Sq == Sk: the JAX oracle masks from the bottom right
    (``tril(k=Sk-Sq)``) where the TPU kernel masks from the top left, and
    the two agree only there, so other shapes raise."""
    B, H, Sq, d = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if causal and Sq != Sk:
        raise ValueError(f"causal attention needs Sq == Sk, got Sq={Sq}, "
                         f"Sk={Sk}")
    G = H // KV
    s = scale if scale is not None else d ** -0.5
    qf = q.float().reshape(B, KV, G, Sq, d)
    scores = torch.einsum("bkgqd,bksd->bkgqs", qf, k.float()) * s
    if causal:
        mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", w, v.float())
    return out.reshape(B, H, Sq, d).to(q.dtype)
