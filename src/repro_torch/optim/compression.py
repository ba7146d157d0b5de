"""Gradient compression for async federated pushes over slow links: top-k
sparsification with error feedback, and int8 symmetric quantization — the
counterpart of ``repro/optim/compression.py``.

At datacenter scale these shrink the cross-island (island-to-server)
update traffic — the analogue of the paper's 2.5 MB LeNet model push over
4G. Plain PyTorch on the tensors' own device: ``torch.topk`` selects,
``index_put_`` scatters back.

``torch.topk`` may order equal magnitudes differently from
``jax.lax.top_k`` (and on CUDA their order is not specified), so two
selections among ties can keep different indices; where the magnitudes
are distinct they keep the same set. ``torch.round`` and ``jnp.round``
both round half to even.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch


class TopK(NamedTuple):
    values: torch.Tensor     # (k,) f32
    indices: torch.Tensor    # (k,) int32 into the flattened tensor
    shape: tuple


def topk_compress(x: torch.Tensor, k: int) -> TopK:
    """The ``k`` entries of ``x`` largest in magnitude (``k`` clamped to
    ``[1, size]``). The size is taken on the host from the shape; at
    ``k == size`` every entry survives and no selection runs; an empty
    tensor gives an empty payload."""
    shape = tuple(x.shape)
    size = math.prod(shape)
    flat = x.reshape(-1).float()
    if size == 0:       # empty tensor (e.g. a zero-size shard slice)
        return TopK(flat, torch.zeros(0, dtype=torch.int32,
                                      device=flat.device), shape)
    k = max(1, min(int(k), size))
    if k == size:       # dense: every entry survives, skip the selection
        return TopK(flat, torch.arange(size, dtype=torch.int32,
                                       device=flat.device), shape)
    idx = torch.topk(flat.abs(), k).indices
    return TopK(flat[idx], idx.to(torch.int32), shape)


def topk_decompress(t: TopK) -> torch.Tensor:
    out = torch.zeros(math.prod(t.shape), dtype=torch.float32,
                      device=t.values.device)
    out[t.indices.long()] = t.values
    return out.reshape(t.shape)


def int8_quantize(x: torch.Tensor):
    """Symmetric int8: ``(q, scale)`` with ``scale = max|x| / 127`` (at
    least 1e-12) a 0-d f32 tensor and ``q = clip(round(x / scale), -127,
    127)``."""
    x = x.float()
    scale = torch.clamp(torch.max(torch.abs(x)) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts/lists/tuples; a tensor and a
    ``TopK`` payload are leaves. ``rest`` share ``tree``'s structure (or
    have a leaf where ``tree`` has one)."""
    if isinstance(tree, TopK) or torch.is_tensor(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    raise TypeError(f"unsupported tree node {type(tree).__name__}")


class ErrorFeedback:
    """Stateful error-feedback wrapper: compress(residual + update), carry
    the compression error forward so the compression is unbiased over
    time."""

    def __init__(self, ratio: float = 0.01, min_k: int = 1):
        self.ratio = ratio
        self.min_k = min_k
        self.residual: Any = None

    def compress(self, tree: Any):
        if self.residual is None:
            self.residual = _map(
                lambda x: torch.zeros_like(x, dtype=torch.float32), tree)
        corrected = _map(lambda x, r: x.float() + r, tree, self.residual)
        payload = _map(
            lambda x: topk_compress(x, max(int(x.numel() * self.ratio),
                                           self.min_k)),
            corrected)
        self.residual = _map(lambda x, t: x - topk_decompress(t),
                             corrected, payload)
        return payload

    @staticmethod
    def decompress(payload: Any):
        return _map(topk_decompress, payload)
