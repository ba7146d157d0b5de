"""Model assembly: the transformer and Mamba2 blocks, their layer stacks
(dense, SSM and the zamba2-style hybrid), the LM head and the loss — the
counterpart of ``repro/models/model.py``.

Parameters are a tree (nested dicts) of tensors as in the JAX package;
``layers`` leaves are stacked with a leading L dimension. A stack is a
Python loop over that dimension (the JAX ``lax.scan``), with
``torch.utils.checkpoint`` per layer when ``cfg.remat == "full"`` and
gradients are on (the JAX ``jax.checkpoint`` of the scan body). A cache
(the KV cache, or the SSM states) has the same leading L dimension; each
layer reads its slice as a view and writes it IN PLACE (the JAX stacks
carry it through the scan with a donated dynamic-update-slice).

``kernel`` (``"auto"``, ``"cuda"`` or ``"reference"``) reaches K4 (the
flash routes of ``attention``) and K3 (``ssm.ssd_chunked``).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.fused_update.ops import tree_leaves, tree_map, tree_unflatten
from .attention import attention, init_attention
from .common import apply_norm, norm_params
from .config import ModelConfig
from .moe import init_mlp, init_moe, mlp, moe
from .ssm import init_ssm, ssm_block, ssm_decode_step


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable[..., Any]
    loss: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    init_cache: Callable[..., Any]


# ------------------------------------------------------------------ blocks
def transformer_block(x, p, cfg, positions=None, mask=None, kv_cache=None,
                      cache_pos=None, cross=None, *, kernel="auto"):
    """Pre-norm residual block. ``cross``: None, or the (k, v) of the
    encoder output — the audio decoder's cross-attention after the
    self-attention (``ln_x`` then ``cross_attn``). Returns (x,
    new_kv_cache, aux): the MoE auxiliary loss, or the number 0.0 for the
    dense MLP (no device op)."""
    h = apply_norm(x, p["ln1"], cfg)
    a, new_cache = attention(h, p["attn"], cfg, positions=positions,
                             mask=mask, kv_cache=kv_cache,
                             cache_pos=cache_pos, kernel=kernel)
    x = x + a
    if cross is not None:
        h = apply_norm(x, p["ln_x"], cfg)
        a, _ = attention(h, p["cross_attn"], cfg, kv_override=cross,
                         kernel=kernel)
        x = x + a
    h = apply_norm(x, p["ln2"], cfg)
    if cfg.family == "moe":
        m, aux = moe(h, p["moe"], cfg)
    else:
        m, aux = mlp(h, p["mlp"], cfg), 0.0
    return x + m, new_cache, aux


def init_transformer_block(generator, cfg, cross: bool = False):
    """The JAX block's leaves in its draw order: attention, then the
    cross-attention (``cross``), then the MLP or the experts."""
    p = {"ln1": norm_params(cfg.d_model, cfg),
         "attn": init_attention(generator, cfg),
         "ln2": norm_params(cfg.d_model, cfg)}
    if cross:
        p["ln_x"] = norm_params(cfg.d_model, cfg)
        p["cross_attn"] = init_attention(generator, cfg)
    if cfg.family == "moe":
        p["moe"] = init_moe(generator, cfg)
    else:
        p["mlp"] = init_mlp(generator, cfg)
    return p


def mamba_layer(x, p, cfg, state=None, *, kernel="auto"):
    h = apply_norm(x, p["ln1"], cfg)
    out, new_state = ssm_block(h, p["ssm"], cfg, state=state, kernel=kernel)
    return x + out, new_state


def init_mamba_layer(generator, cfg):
    return {"ln1": norm_params(cfg.d_model, cfg),
            "ssm": init_ssm(generator, cfg)}


# ------------------------------------------------------------------ stacks
def _stacked_init(init_one, generator, n):
    """``n`` draws of ``init_one(generator)`` stacked on a leading dim.
    Each layer is drawn and copied into preallocated stacked leaves
    before the next is drawn, so the peak is the stack plus one layer
    (stacking a list of n layers would hold twice the stack)."""
    layer = init_one(generator)
    stack = tree_map(lambda t: torch.empty((n,) + t.shape, dtype=t.dtype,
                                           device=t.device), layer)
    for i in range(n):
        if i:
            layer = init_one(generator)
        for dst, src in zip(tree_leaves(stack), tree_leaves(layer)):
            dst[i].copy_(src)
        layer = None
    return stack


def _layers(layers_p, cache=None):
    """Per layer: (its parameter tree, its cache slice or None). Each leaf
    is unbound once, so the backward pass stacks the per-layer gradients
    of a leaf in one op; cache slices are views."""
    per_leaf = [t.unbind(0) for t in tree_leaves(layers_p)]
    for i, layer in enumerate(zip(*per_leaf)):
        yield (tree_unflatten(layers_p, list(layer)),
               None if cache is None else tree_map(lambda t: t[i], cache))


def _remat(cfg):
    return cfg.remat == "full" and torch.is_grad_enabled()


def dense_stack(x, layers_p, cfg, positions=None, cache=None,
                cache_pos=None, *, mask=None, kernel="auto"):
    """The layer loop over the stacked parameters. ``cache``: None, or
    {"k", "v"} of (L, B, Smax, KV, hd), written in place; ``mask``: as
    ``attention``'s (``True``: the audio encoder's non-causal stack).
    Returns (x, cache, the layers' summed MoE auxiliary loss (0.0 for the
    dense family))."""
    aux_sum = 0.0
    for p, kv in _layers(layers_p, cache):
        if kv is None and _remat(cfg):
            x, _, aux = checkpoint(transformer_block, x, p, cfg, positions,
                                   mask, kernel=kernel, use_reentrant=False)
        else:
            x, _, aux = transformer_block(x, p, cfg, positions, mask,
                                          kv_cache=kv, cache_pos=cache_pos,
                                          kernel=kernel)
        aux_sum = aux_sum + aux
    return x, cache, aux_sum


def ssm_stack(x, layers_p, cfg, states=None, *, kernel="auto"):
    """The Mamba2 layer loop. ``states``: None (training), or {"conv",
    "ssd"} with a leading L dimension, written in place (prefill). Returns
    (x, states)."""
    for p, st in _layers(layers_p, states):
        if st is None and _remat(cfg):
            x, _ = checkpoint(mamba_layer, x, p, cfg, kernel=kernel,
                              use_reentrant=False)
        else:
            x, _ = mamba_layer(x, p, cfg, state=st, kernel=kernel)
    return x, states


def ssm_decode_stack(x, layers_p, cfg, states):
    """One decode token through every Mamba2 layer; ``states`` written in
    place. Returns (x, states)."""
    for p, st in _layers(layers_p, states):
        h = apply_norm(x, p["ln1"], cfg)
        out, _ = ssm_decode_step(h, p["ssm"], cfg, st)
        x = x + out
    return x, states


def hybrid_stack(x, params, cfg, positions=None, ssm_states=None,
                 attn_cache=None, cache_pos=None, decode=False, *,
                 kernel="auto"):
    """zamba2-style: G = L / P groups of ``hybrid_period`` (P) Mamba2
    layers, each followed by shared block ``gi % num_shared_blocks`` with
    its own KV cache slot ``gi``. ``ssm_states``: None (training), or the
    {"conv", "ssd"} states with a leading L; ``attn_cache``: None, or
    {"k", "v"} with a leading G; ``decode``: one token through the
    recurrent step. The grouped states and parameters are reshapes of the
    contiguous L leaves (views), so the stacks write the states IN PLACE.
    Returns (x, ssm_states, attn_cache)."""
    L, P = cfg.num_layers, cfg.hybrid_period
    G = L // P

    mamba_g = tree_map(lambda t: t.reshape((G, P) + t.shape[1:]),
                       params["mamba"])
    # views: a copy would drop the states the stacks write
    ssm_g = None if ssm_states is None else tree_map(
        lambda t: t.view((G, P) + t.shape[1:]), ssm_states)
    shared = [p for p, _ in _layers(params["shared"])]
    for gi, (mamba_p, st) in enumerate(_layers(mamba_g, ssm_g)):
        if decode:
            x, _ = ssm_decode_stack(x, mamba_p, cfg, st)
        else:
            x, _ = ssm_stack(x, mamba_p, cfg, states=st, kernel=kernel)
        kv = None if attn_cache is None else tree_map(lambda t: t[gi],
                                                      attn_cache)
        shared_p = shared[gi % cfg.num_shared_blocks]
        if kv is None and _remat(cfg):
            x, _, _ = checkpoint(transformer_block, x, shared_p, cfg,
                                 positions, kernel=kernel,
                                 use_reentrant=False)
        else:
            x, _, _ = transformer_block(x, shared_p, cfg, positions,
                                        kv_cache=kv, cache_pos=cache_pos,
                                        kernel=kernel)
    return x, ssm_states, attn_cache


# ------------------------------------------------------------------ LM heads
def _lm_logits(x, params, cfg):
    x = apply_norm(x, params["final_norm"], cfg)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head.to(x.dtype)
    if cfg.logits_softcap:
        logits = cfg.logits_softcap * torch.tanh(logits / cfg.logits_softcap)
    return logits


def cross_entropy(logits, labels, mask=None):
    """logits (B,S,V) any dtype; labels (B,S) int. Returns mean NLL (f32),
    a gather of the true logit (no one-hot), masked by ``labels >= 0``."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    labels = labels.long()
    true_logit = torch.gather(logits, -1,
                              labels.clamp(min=0)[..., None])[..., 0]
    nll = lse - true_logit
    if mask is None:
        mask = (labels >= 0).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
