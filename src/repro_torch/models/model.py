"""Model assembly for the training path: the transformer block, the layer
stack, the LM head and the loss — the counterpart of
``repro/models/model.py`` for the dense family.

Parameters are a tree (nested dicts) of tensors as in the JAX package;
``layers`` leaves are stacked with a leading L dimension. ``dense_stack``
is a Python loop over that dimension (the JAX ``lax.scan``), with
``torch.utils.checkpoint`` per layer when ``cfg.remat == "full"`` (the JAX
``jax.checkpoint`` of the scan body). The KV-cache paths, the SSM and
hybrid stacks and the MoE block are still to port (ROADMAP Queue 1
item 12).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.fused_update.ops import tree_leaves, tree_map, tree_unflatten
from .attention import attention, init_attention
from .common import apply_norm, norm_params
from .config import ModelConfig
from .moe import init_mlp, mlp


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable[..., Any]
    loss: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    init_cache: Callable[..., Any]


def _dense_only(cfg):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1 "
            "item 12)")


# ------------------------------------------------------------------ blocks
def transformer_block(x, p, cfg, positions=None, mask=None):
    """Pre-norm residual block of the dense family. The JAX block also
    returns a KV cache and the MoE auxiliary loss; on the dense training
    path they are None and 0."""
    _dense_only(cfg)
    h = apply_norm(x, p["ln1"], cfg)
    x = x + attention(h, p["attn"], cfg, positions=positions, mask=mask)
    h = apply_norm(x, p["ln2"], cfg)
    return x + mlp(h, p["mlp"], cfg)


def init_transformer_block(generator, cfg):
    _dense_only(cfg)
    return {"ln1": norm_params(cfg.d_model, cfg),
            "attn": init_attention(generator, cfg),
            "ln2": norm_params(cfg.d_model, cfg),
            "mlp": init_mlp(generator, cfg)}


# ------------------------------------------------------------------ stacks
def _stacked_init(init_one, generator, n):
    """``n`` draws of ``init_one(generator)`` stacked on a leading dim."""
    layers = [init_one(generator) for _ in range(n)]
    return tree_map(lambda *xs: torch.stack(xs), *layers)


def dense_stack(x, layers_p, cfg, positions=None):
    """The layer loop over the stacked parameters (no cache). Each leaf is
    unbound once, so the backward pass stacks the per-layer gradients of a
    leaf in one op."""
    per_leaf = [t.unbind(0) for t in tree_leaves(layers_p)]
    for layer in zip(*per_leaf):
        p = tree_unflatten(layers_p, list(layer))
        if cfg.remat == "full" and torch.is_grad_enabled():
            x = checkpoint(transformer_block, x, p, cfg, positions,
                           use_reentrant=False)
        else:
            x = transformer_block(x, p, cfg, positions)
    return x


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
