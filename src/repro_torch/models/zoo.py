"""``build_model(cfg, kernel=...) -> Model`` — the counterpart of
``repro/models/zoo.py`` for the dense decoder-only LM and the pure SSM LM.

Every family exposes the JAX package's functional API:

    model.init(generator, device="cuda")     -> params tree
    model.loss(params, batch)                -> (scalar, metrics)
    model.init_cache(batch, max_seq, device="cuda") -> cache (zeros)
    model.prefill(params, batch, cache)      -> (last_logits, cache)
    model.decode_step(params, cache, batch)  -> (logits, cache)

``init`` draws the parameters on the CPU from a ``torch.Generator`` and
moves them to ``device``. The embedding is looked up in f32 and cast to
``cfg.dtype``; with tied embeddings the same leaf is the LM head. The
cache's ``pos`` is a Python int (JAX carries an int32 array): the decode
loop then builds its positions and masks on the device without reading
anything back, and prefill/decode write the cache tensors in place.

``kernel`` (``"auto"``, ``"cuda"`` or ``"reference"``) picks how K4 (the
``attention_impl="flash"`` route) and K3 (the SSD intra-chunk step) run.
The MoE, hybrid, audio and VLM families are still to port (ROADMAP Queue 1
item 12). ``params_from_jax`` carries a JAX parameter tree across (the two
libraries draw different numbers from one seed).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import mode
from ..kernels.fused_update.ops import tree_map
from .common import dense_init, embed_init, norm_params
from .config import ModelConfig
from .model import (Model, _lm_logits, _stacked_init, cross_entropy,
                    dense_stack, init_mamba_layer, init_transformer_block,
                    ssm_decode_stack, ssm_stack)
from .ssm import init_ssm_state


def _adt(cfg):
    return getattr(torch, cfg.dtype)


def _embed_tokens(params, tokens, cfg):
    return params["embed"][tokens.long()].to(_adt(cfg))


def _init_lm(cfg, init_layer):
    def init(generator: torch.Generator, device="cuda"):
        dev = resolve_device(device)
        p = {"embed": embed_init(generator, cfg.vocab_size, cfg.d_model),
             "layers": _stacked_init(lambda g: init_layer(g, cfg), generator,
                                     cfg.num_layers),
             "final_norm": norm_params(cfg.d_model, cfg)}
        if not cfg.tie_embeddings:
            p["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab_size)
        return tree_map(lambda t: t.to(dev), p)

    return init


def _kv_cache_zeros(cfg, n_layers, batch, max_seq, device):
    shape = (n_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=_adt(cfg), device=device),
            "v": torch.zeros(shape, dtype=_adt(cfg), device=device)}


# ============================================================ decoder-only LM
def build_lm(cfg: ModelConfig, kernel: str = "auto") -> Model:
    """The dense decoder-only LM."""
    if cfg.num_vision_tokens:
        raise NotImplementedError(
            "vision tokens (the VLM family) are not ported yet (ROADMAP "
            "Queue 1 item 12)")

    def loss(params, batch):
        x = _embed_tokens(params, batch["tokens"], cfg)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _ = dense_stack(x, params["layers"], cfg, positions=positions,
                           kernel=kernel)
        l = cross_entropy(_lm_logits(x, params, cfg), batch["labels"])
        # the dense family has no MoE auxiliary loss: 0.01 * aux == 0
        return l, {"loss": l, "aux_loss": torch.zeros((), device=l.device)}

    def init_cache(batch, max_seq, device="cuda"):
        dev = resolve_device(device)
        return {"layers": _kv_cache_zeros(cfg, cfg.num_layers, batch,
                                          max_seq, dev),
                "pos": 0}

    def prefill(params, batch, cache):
        x = _embed_tokens(params, batch["tokens"], cfg)
        positions = torch.arange(x.shape[1], device=x.device)
        x, kv = dense_stack(x, params["layers"], cfg, positions=positions,
                            cache=cache["layers"], cache_pos=0,
                            kernel=kernel)
        logits = _lm_logits(x[:, -1:, :], params, cfg)
        return logits, {"layers": kv, "pos": x.shape[1]}

    def decode_step(params, cache, batch):
        pos = cache["pos"]
        x = _embed_tokens(params, batch["tokens"], cfg)          # (B,1,D)
        positions = torch.arange(pos, pos + x.shape[1], device=x.device)
        x, kv = dense_stack(x, params["layers"], cfg, positions=positions,
                            cache=cache["layers"], cache_pos=pos,
                            kernel=kernel)
        return _lm_logits(x, params, cfg), {"layers": kv,
                                            "pos": pos + x.shape[1]}

    return Model(cfg, _init_lm(cfg, init_transformer_block), loss, prefill,
                 decode_step, init_cache)


# ================================================================ pure SSM LM
def build_ssm_lm(cfg: ModelConfig, kernel: str = "auto") -> Model:
    """The attention-free Mamba2 LM."""

    def loss(params, batch):
        x = _embed_tokens(params, batch["tokens"], cfg)
        x, _ = ssm_stack(x, params["layers"], cfg, kernel=kernel)
        l = cross_entropy(_lm_logits(x, params, cfg), batch["labels"])
        return l, {"loss": l}

    def init_cache(batch, max_seq, device="cuda"):
        dev = resolve_device(device)
        st = init_ssm_state(cfg, batch, device=dev)
        return {"layers": tree_map(
                    lambda t: torch.zeros((cfg.num_layers,) + t.shape,
                                          dtype=t.dtype, device=dev), st),
                "pos": 0}

    def prefill(params, batch, cache):
        x = _embed_tokens(params, batch["tokens"], cfg)
        x, states = ssm_stack(x, params["layers"], cfg,
                              states=cache["layers"], kernel=kernel)
        logits = _lm_logits(x[:, -1:, :], params, cfg)
        return logits, {"layers": states, "pos": x.shape[1]}

    def decode_step(params, cache, batch):
        x = _embed_tokens(params, batch["tokens"], cfg)
        x, states = ssm_decode_stack(x, params["layers"], cfg,
                                     cache["layers"])
        return _lm_logits(x, params, cfg), {"layers": states,
                                            "pos": cache["pos"] + 1}

    return Model(cfg, _init_lm(cfg, init_mamba_layer), loss, prefill,
                 decode_step, init_cache)


FAMILIES = {"dense": build_lm, "ssm": build_ssm_lm}


def build_model(cfg: ModelConfig, kernel: str = "auto") -> Model:
    mode.check_kernel_mode(kernel, "cuda")
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1 "
            f"item 12); the port builds {sorted(FAMILIES)}")
    return FAMILIES[cfg.family](cfg, kernel)


def params_from_jax(tree, device="cuda"):
    """A JAX parameter tree (nested dicts of numpy or jax arrays) as the
    port's tree of tensors on ``device``, dtypes and the stacked leading
    layer dimension kept."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(dev)
