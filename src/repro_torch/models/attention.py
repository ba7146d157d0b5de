"""GQA attention with RoPE and qk-norm — the counterpart of
``repro/models/attention.py`` for the training path (no KV cache).

Numerics follow the JAX package: every projection casts its f32 weight to
the activation dtype; the scores ``q k^T`` come out in that dtype and are
scaled in f32; the causal mask writes ``finfo(float32).min`` (not -inf);
the softmax runs in f32 and its weights are cast back to the activation
dtype before ``w v``. GQA groups query heads as ``(KV, G)``, so query head
h reads KV head ``h // G``.

Only ``attention_impl="xla"`` (einsum attention) is ported; ``chunked``
raises, and the flash kernel (K4) is still to port (ROADMAP Queue 2). The
KV-cache decode and the cross-attention of the JAX ``attention`` are
still to port with prefill/decode (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

import torch

from .common import apply_rope, dense_init, rms_norm


def init_attention(generator, cfg, d_model=None):
    D = d_model or cfg.d_model
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(generator, D, H * hd),
        "wk": dense_init(generator, D, KV * hd),
        "wv": dense_init(generator, D, KV * hd),
        "wo": dense_init(generator, H * hd, D),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(H * hd)
        p["bk"] = torch.zeros(KV * hd)
        p["bv"] = torch.zeros(KV * hd)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(hd)
        p["k_norm"] = torch.zeros(hd)
    return p


def _project_qkv(x, p, cfg, positions):
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(B, S, H, hd)
    k = (x @ p["wk"].to(dt)).reshape(B, S, KV, hd)
    v = (x @ p["wv"].to(dt)).reshape(B, S, KV, hd)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt).reshape(H, hd)
        k = k + p["bk"].to(dt).reshape(KV, hd)
        v = v + p["bv"].to(dt).reshape(KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if positions is not None:   # rope (None => positions handled by caller)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, cfg):
    """q: (B,Sq,H,hd)  k/v: (B,Sk,KV,hd). GQA via head grouping."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    q = q.reshape(B, Sq, KV, G, hd)
    scale = hd ** -0.5
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k).float() * scale
    if cfg.logits_softcap:
        scores = cfg.logits_softcap * torch.tanh(scores / cfg.logits_softcap)
    if mask is not None:
        scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v)
    return out.reshape(B, Sq, H, hd)


def causal_mask(Sq: int, Sk: int, offset: int = 0, device=None):
    """mask[i, j] = query (offset+i) may attend key j."""
    qi = torch.arange(Sq, device=device)[:, None] + offset
    kj = torch.arange(Sk, device=device)[None, :]
    return (kj <= qi)[None, None, None, :, :]   # (1,1,1,Sq,Sk) for bkgqs


def attention(x, p, cfg, positions=None, mask=None):
    """Full attention block body (no residual / norm): the JAX function's
    ``out`` (its second result, the new KV cache, is always None on the
    training path)."""
    if cfg.attention_impl == "chunked":
        raise NotImplementedError(
            "attention_impl='chunked' is not ported yet (ROADMAP Queue 1 "
            "item 12)")
    q, k, v = _project_qkv(x, p, cfg, positions)
    if mask is None and cfg.causal:
        mask = causal_mask(q.shape[1], k.shape[1], device=x.device)
    out = _sdpa(q, k, v, mask, cfg)
    B, Sq = x.shape[:2]
    return out.reshape(B, Sq, cfg.num_heads * cfg.head_dim) \
        @ p["wo"].to(x.dtype)
