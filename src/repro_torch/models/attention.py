"""GQA attention with RoPE, qk-norm and the KV cache — the counterpart of
``repro/models/attention.py``.

Numerics follow the JAX package: every projection casts its f32 weight to
the activation dtype; the scores ``q k^T`` come out in that dtype and are
scaled in f32; the causal mask writes ``finfo(float32).min`` (not -inf);
the softmax runs in f32 and its weights are cast back to the activation
dtype before ``w v``. GQA groups query heads as ``(KV, G)``, so query head
h reads KV head ``h // G``.

``attention_impl``:
- ``"xla"``: the einsum attention ``_sdpa`` (with a cache, over all its
  slots, the unwritten ones masked), as in the JAX package;
- ``"flash"``: causal self-attention with Sq == Sk — training without a
  cache, and the prefill (``cache_pos == 0``) on its fresh keys — goes
  through K4 (``kernels/flash_attention``, the CUDA kernel on CUDA
  tensors). At ``cache_pos == 0`` every cache slot past Sq is masked and
  contributes exactly 0, so K4 on the fresh keys is the same function as
  ``_sdpa`` over the cache. Decode (Sq = 1 over the cache) and an explicit
  mask stay on ``_sdpa``; a ``logits_softcap`` is not part of K4's
  contract and raises;
- ``"chunked"`` and cross-attention (``kv_override``) are still to port
  (ROADMAP Queue 1 item 7) and raise.

``kernel`` (``"auto"``, ``"cuda"`` or ``"reference"``) picks how K4 runs.
K4 has no backward: a flash call that needs a gradient raises on CUDA.
"""
from __future__ import annotations

import torch

from ..kernels.flash_attention import flash_attention
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


def _flash(q, k, v, kernel):
    """K4 on (B, S, heads, hd) activations, as (B, heads, S, hd) views;
    the output comes back in the (B, S, H, hd) layout."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=True, kernel=kernel)
    return out.transpose(1, 2)


def attention(x, p, cfg, positions=None, mask=None, kv_cache=None,
              cache_pos=None, kv_override=None, *, kernel="auto"):
    """Full attention block body (no residual / norm). Returns
    ``(out, new_cache)``.

    ``kv_cache``: None, or {"k", "v"} of (B, Smax, KV, hd) — the new k/v
    are written at ``cache_pos`` (a Python int) IN PLACE into these
    tensors, which ``new_cache`` returns (JAX's functional update is
    donated, so it too keeps one cache), and attention runs over the whole
    cache."""
    if kv_override is not None:
        raise NotImplementedError(
            "cross-attention (kv_override, the audio family) is not ported "
            "yet (ROADMAP Queue 1 item 7)")
    if cfg.attention_impl == "chunked":
        raise NotImplementedError(
            "attention_impl='chunked' is not ported yet (ROADMAP Queue 1 "
            "item 7)")
    flash = cfg.attention_impl == "flash"
    if flash and cfg.logits_softcap:
        raise NotImplementedError(
            "attention_impl='flash' with logits_softcap: a softcap is not "
            "part of K4's contract")
    q, k, v = _project_qkv(x, p, cfg, positions)
    dt = x.dtype
    new_cache = None
    if kv_cache is not None:
        S = q.shape[1]
        kv_cache["k"][:, cache_pos:cache_pos + S] = k
        kv_cache["v"][:, cache_pos:cache_pos + S] = v
        new_cache = kv_cache
        if flash and mask is None and cfg.causal and cache_pos == 0:
            ck, cv = kv_cache["k"][:, :S], kv_cache["v"][:, :S]
            out = _flash(q, ck.to(dt), cv.to(dt), kernel)
        else:
            if mask is None:
                mask = causal_mask(S, kv_cache["k"].shape[1],
                                   offset=cache_pos, device=x.device)
            out = _sdpa(q, kv_cache["k"].to(dt), kv_cache["v"].to(dt), mask,
                        cfg)
    elif flash and mask is None and cfg.causal:
        out = _flash(q, k, v, kernel)
    else:
        if mask is None and cfg.causal:
            mask = causal_mask(q.shape[1], k.shape[1], device=x.device)
        out = _sdpa(q, k, v, mask, cfg)
    B, Sq = x.shape[:2]
    out = out.reshape(B, Sq, cfg.num_heads * cfg.head_dim) \
        @ p["wo"].to(dt)
    return out, new_cache
