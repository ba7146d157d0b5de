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
- ``"chunked"``: ``_sdpa_chunked`` (scores for ``attn_q_block`` query
  rows at a time, in f32, each block recomputed in the backward pass)
  for causal attention with ``Sq >= 2 * attn_q_block`` — training, and
  over the whole cache at ``cache_pos`` — as in the JAX package; shorter
  queries, decode and an explicit mask stay on ``_sdpa``.

Cross-attention (``kv_override``, the audio family) is still to port
(ROADMAP Queue 1 item 7) and raises.

``kernel`` (``"auto"``, ``"cuda"`` or ``"reference"``) picks how K4 runs.
K4 has no backward: a flash call that needs a gradient raises on CUDA.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

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


def _sdpa_chunked(q, k, v, cfg, *, causal: bool = True, offset: int = 0):
    """Blocked attention: the scores of ``attn_q_block`` query rows at a
    time, peak memory (B, KV, G, bq, Sk) instead of (..., Sq, Sk); q, k and
    v in f32, the output cast back to q's dtype. ``offset``: the position
    of query row 0 (the cache position). q: (B, Sq, H, hd); k/v: (B, Sk,
    KV, hd)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    bq = min(cfg.attn_q_block, Sq)
    nb = Sq // bq
    scale = hd ** -0.5
    kf, vf = k.float(), v.float()
    cols = torch.arange(Sk, device=q.device)[None, :]

    def block(qb, qstart):
        """qb: (B, bq', KV, G, hd) -> (B, bq', KV, G, hd)"""
        s = torch.einsum("bqkgh,bskh->bkgqs", qb.float(), kf) * scale
        if cfg.logits_softcap:
            s = cfg.logits_softcap * torch.tanh(s / cfg.logits_softcap)
        if causal:
            rows = offset + qstart + torch.arange(
                qb.shape[1], device=q.device)[:, None]
            s = torch.where(cols <= rows, s, torch.finfo(torch.float32).min)
        w = torch.softmax(s, dim=-1)
        return torch.einsum("bkgqs,bskh->bqkgh", w, vf).to(q.dtype)

    # each block recomputed in the backward pass (the JAX checkpoint):
    # otherwise every block's (bq, Sk) weights are kept, O(Sq Sk) again
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    qg = q.reshape(B, Sq, KV, G, hd)
    outs = []
    for i in range(nb + (Sq > nb * bq)):    # the tail block, if any, last
        qb = qg[:, i * bq:(i + 1) * bq]
        outs.append(checkpoint(block, qb, i * bq, use_reentrant=False)
                    if remat else block(qb, i * bq))
    return torch.cat(outs, dim=1).reshape(B, Sq, H, hd)


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
    flash = cfg.attention_impl == "flash"
    if flash and cfg.logits_softcap:
        raise NotImplementedError(
            "attention_impl='flash' with logits_softcap: a softcap is not "
            "part of K4's contract")
    q, k, v = _project_qkv(x, p, cfg, positions)
    dt = x.dtype
    chunked = cfg.attention_impl == "chunked" and mask is None and \
        cfg.causal and q.shape[1] >= 2 * cfg.attn_q_block
    new_cache = None
    if kv_cache is not None:
        S = q.shape[1]
        kv_cache["k"][:, cache_pos:cache_pos + S] = k
        kv_cache["v"][:, cache_pos:cache_pos + S] = v
        new_cache = kv_cache
        if flash and mask is None and cfg.causal and cache_pos == 0:
            ck, cv = kv_cache["k"][:, :S], kv_cache["v"][:, :S]
            out = _flash(q, ck.to(dt), cv.to(dt), kernel)
        elif chunked:
            out = _sdpa_chunked(q, kv_cache["k"].to(dt),
                                kv_cache["v"].to(dt), cfg, causal=True,
                                offset=cache_pos)
        else:
            if mask is None:
                mask = causal_mask(S, kv_cache["k"].shape[1],
                                   offset=cache_pos, device=x.device)
            out = _sdpa(q, kv_cache["k"].to(dt), kv_cache["v"].to(dt), mask,
                        cfg)
    elif flash and mask is None and cfg.causal:
        out = _flash(q, k, v, kernel)
    elif chunked:
        out = _sdpa_chunked(q, k, v, cfg, causal=True)
    else:
        if mask is None and cfg.causal:
            mask = causal_mask(q.shape[1], k.shape[1], device=x.device)
        out = _sdpa(q, k, v, mask, cfg)
    B, Sq = x.shape[:2]
    out = out.reshape(B, Sq, cfg.num_heads * cfg.head_dim) \
        @ p["wo"].to(dt)
    return out, new_cache
