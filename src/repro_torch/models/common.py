"""Shared building blocks: init, norms, RoPE, activations — the
counterpart of ``repro/models/common.py``.

Numerics follow the JAX package: norms and RoPE compute in f32 and cast
back to the activation dtype; RMSNorm stores ``scale - 1`` (zeros at
init) and multiplies by ``1 + scale``; LayerNorm (the audio family) keeps
``scale`` (ones) and ``bias`` (zeros) and normalises by the biased
variance, as ``jnp.var`` does; RoPE rotates the two halves of the head
dimension (not interleaved pairs).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _trunc_normal(generator, shape, std):
    t = torch.empty(shape, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return t.mul_(std)


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int):
    """Fan-in scaled truncated normal (+-3 sigma), f32, (in, out) layout,
    drawn from ``generator`` on its device: a CPU generator (the default
    everywhere) gives every device the same values from one seed; a CUDA
    generator draws a full-width model on the card in a fraction of a
    second, with other values."""
    return _trunc_normal(generator, (in_dim, out_dim), in_dim ** -0.5)


def embed_init(generator: torch.Generator, vocab: int, dim: int):
    """dim^-0.5-scaled: keeps tied-embedding logits O(1) at init."""
    return _trunc_normal(generator, (vocab, dim), dim ** -0.5)


def rms_norm(x, scale, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def apply_norm(x, p, cfg):
    if cfg.norm_type == "layernorm":
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm(x, p["scale"], cfg.norm_eps)


def norm_params(dim: int, cfg):
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}
    return {"scale": torch.zeros(dim)}      # rmsnorm stores (scale - 1)


# --------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # (hd/2,)
    ang = positions[..., None].float() * freqs                   # (..., seq, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def gelu(x):
    return F.gelu(x, approximate="tanh")


ACTS = {"silu": F.silu, "gelu": gelu}
