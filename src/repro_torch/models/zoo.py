"""``build_model(cfg) -> Model`` — the counterpart of
``repro/models/zoo.py`` for the dense decoder-only LM.

``Model.init(generator, device="cuda")`` draws the parameters on the CPU
from a ``torch.Generator`` and moves them to ``device``; ``Model.loss
(params, batch)`` returns ``(loss, metrics)`` for a batch of
``{"tokens", "labels"}`` (B, S) integer tensors. The embedding is looked
up in f32 and cast to ``cfg.dtype``; with tied embeddings the same leaf
is the LM head, so it gets gradient from both uses.

``prefill``/``decode_step``/``init_cache`` and the MoE, SSM, hybrid,
audio and VLM families are still to port (ROADMAP Queue 1 item 12).
``params_from_jax`` carries a JAX parameter tree across (the two
libraries draw different numbers from one seed).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.fused_update.ops import tree_map
from .common import dense_init, embed_init, norm_params
from .config import ModelConfig
from .model import (Model, _lm_logits, _stacked_init, cross_entropy,
                    dense_stack, init_transformer_block)


def _adt(cfg):
    return getattr(torch, cfg.dtype)


def _embed_tokens(params, tokens, cfg):
    return params["embed"][tokens.long()].to(_adt(cfg))


def _not_ported(what):
    def raise_(*args, **kwargs):
        raise NotImplementedError(
            f"{what} is not ported yet (ROADMAP Queue 1 item 12)")
    return raise_


def build_lm(cfg: ModelConfig) -> Model:
    """The dense decoder-only LM."""
    if cfg.num_vision_tokens:
        raise NotImplementedError(
            "vision tokens (the VLM family) are not ported yet (ROADMAP "
            "Queue 1 item 12)")

    def init(generator: torch.Generator, device="cuda"):
        dev = resolve_device(device)
        p = {"embed": embed_init(generator, cfg.vocab_size, cfg.d_model),
             "layers": _stacked_init(
                 lambda g: init_transformer_block(g, cfg), generator,
                 cfg.num_layers),
             "final_norm": norm_params(cfg.d_model, cfg)}
        if not cfg.tie_embeddings:
            p["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab_size)
        return tree_map(lambda t: t.to(dev), p)

    def loss(params, batch):
        x = _embed_tokens(params, batch["tokens"], cfg)
        positions = torch.arange(x.shape[1], device=x.device)
        x = dense_stack(x, params["layers"], cfg, positions=positions)
        l = cross_entropy(_lm_logits(x, params, cfg), batch["labels"])
        # the dense family has no MoE auxiliary loss: 0.01 * aux == 0
        return l, {"loss": l, "aux_loss": torch.zeros((), device=l.device)}

    return Model(cfg, init, loss, _not_ported("prefill"),
                 _not_ported("decode_step"), _not_ported("init_cache"))


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1 "
            "item 12)")
    return build_lm(cfg)


def params_from_jax(tree, device="cuda"):
    """A JAX parameter tree (nested dicts of numpy or jax arrays) as the
    port's tree of tensors on ``device``, dtypes and the stacked leading
    layer dimension kept."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(dev)
