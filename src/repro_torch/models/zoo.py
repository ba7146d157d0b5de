"""``build_model(cfg, kernel=...) -> Model`` — the counterpart of
``repro/models/zoo.py`` for every family of the JAX zoo: the decoder-only
LM (the dense, MoE and VLM families), the pure SSM LM, the zamba2-style
hybrid and the whisper-style encoder-decoder (the audio family).

Every family exposes the JAX package's functional API:

    model.init(generator, device="cuda")     -> params tree
    model.loss(params, batch)                -> (scalar, metrics)
    model.init_cache(batch, max_seq, device="cuda") -> cache (zeros)
    model.prefill(params, batch, cache)      -> (last_logits, cache)
    model.decode_step(params, cache, batch)  -> (logits, cache)

``init`` draws the parameters from a ``torch.Generator`` on its device
(the CPU unless a CUDA generator is given) and moves them to ``device``.
The embedding is looked up in f32 and cast to ``cfg.dtype``; with tied
embeddings the same leaf is the LM head. The cache's ``pos`` is a Python
int (JAX carries an int32 array): the decode loop then builds its
positions and masks on the device without reading anything back, and
prefill/decode write the cache tensors in place.

Family inputs, as in the JAX package: the VLM family prepends
``batch["vision_embeds"]`` (B, Nv, D) to the token embeddings (positions
run over Nv + S, the loss drops the first Nv rows, the cache holds
``max_seq + Nv`` slots); the audio family encodes
``batch["audio_embeds"]`` (B, encoder_seq, D), a stub of the conv
frontend, with the learned ``enc_pos`` added and no RoPE, non-causally,
and its decoder (with RoPE, as the JAX code passes positions) attends to
the encoder through cross-attention whose K/V are computed once at
prefill into ``cache["cross"]``. The hybrid family's cache is
``{"ssm", "attn", "pos"}`` with one KV slot per group of
``hybrid_period`` Mamba2 layers.

``kernel`` (``"auto"``, ``"cuda"`` or ``"reference"``) picks how K4 (the
``attention_impl="flash"`` routes) and K3 (the SSD intra-chunk step) run.
The MoE family's loss is ``loss + 0.01 * aux`` with ``{"loss",
"aux_loss"}`` in its metrics, as in JAX. ``params_from_jax`` carries a
JAX parameter tree across (the two libraries draw different numbers from
one seed). ``param_specs(cfg)`` is the shape-only tree ``init`` draws:
meta tensors, nothing allocated or drawn.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..kernels import mode
from ..kernels.fused_update.ops import tree_map
from .attention import cross_kv
from .common import apply_norm, dense_init, embed_init, norm_params
from .config import ModelConfig
from .model import (Model, _layers, _lm_logits, _remat, _stacked_init,
                    cross_entropy, dense_stack, hybrid_stack,
                    init_mamba_layer, init_transformer_block,
                    ssm_decode_stack, ssm_stack, transformer_block)
from .ssm import init_ssm_state


def _adt(cfg):
    return getattr(torch, cfg.dtype)


def _embed_tokens(params, tokens, cfg):
    return params["embed"][tokens.long()].to(_adt(cfg))


def _init_lm(cfg, init_layers):
    """``init`` of a decoder-only LM whose ``layers`` tree
    ``init_layers(generator)`` draws."""
    def init(generator: torch.Generator, device="cuda"):
        dev = resolve_device(device)
        p = {"embed": embed_init(generator, cfg.vocab_size, cfg.d_model),
             "layers": init_layers(generator),
             "final_norm": norm_params(cfg.d_model, cfg)}
        if not cfg.tie_embeddings:
            p["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab_size)
        return tree_map(lambda t: t.to(dev), p)

    return init


def _stacked(init_layer, cfg, n):
    return lambda g: _stacked_init(lambda g1: init_layer(g1, cfg), g, n)


def _kv_cache_zeros(cfg, n_layers, batch, max_seq, device):
    shape = (n_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=_adt(cfg), device=device),
            "v": torch.zeros(shape, dtype=_adt(cfg), device=device)}


def _ssm_states_zeros(cfg, batch, device):
    st = init_ssm_state(cfg, batch, device=device)
    return tree_map(lambda t: torch.zeros((cfg.num_layers,) + t.shape,
                                          dtype=t.dtype, device=device), st)


# ============================================================ decoder-only LM
def build_lm(cfg: ModelConfig, kernel: str = "auto") -> Model:
    """The decoder-only LM of the dense, MoE and VLM families."""
    Nv = cfg.num_vision_tokens

    def embed_inputs(params, batch):
        x = _embed_tokens(params, batch["tokens"], cfg)
        if Nv:
            x = torch.cat([batch["vision_embeds"].to(_adt(cfg)), x], dim=1)
        return x, torch.arange(x.shape[1], device=x.device)

    def loss(params, batch):
        x, positions = embed_inputs(params, batch)
        x, _, aux = dense_stack(x, params["layers"], cfg,
                                positions=positions, kernel=kernel)
        l = cross_entropy(_lm_logits(x[:, Nv:], params, cfg),
                          batch["labels"])
        if cfg.family != "moe":     # no auxiliary loss: 0.01 * 0 adds 0
            return l, {"loss": l, "aux_loss": torch.zeros((), device=l.device)}
        return l + 0.01 * aux, {"loss": l, "aux_loss": aux}

    def init_cache(batch, max_seq, device="cuda"):
        dev = resolve_device(device)
        return {"layers": _kv_cache_zeros(cfg, cfg.num_layers, batch,
                                          max_seq + Nv, dev),
                "pos": 0}

    def prefill(params, batch, cache):
        x, positions = embed_inputs(params, batch)
        x, kv, _ = dense_stack(x, params["layers"], cfg,
                               positions=positions, cache=cache["layers"],
                               cache_pos=0, kernel=kernel)
        logits = _lm_logits(x[:, -1:, :], params, cfg)
        return logits, {"layers": kv, "pos": x.shape[1]}

    def decode_step(params, cache, batch):
        pos = cache["pos"]
        x = _embed_tokens(params, batch["tokens"], cfg)          # (B,1,D)
        positions = torch.arange(pos, pos + x.shape[1], device=x.device)
        x, kv, _ = dense_stack(x, params["layers"], cfg,
                               positions=positions, cache=cache["layers"],
                               cache_pos=pos, kernel=kernel)
        return _lm_logits(x, params, cfg), {"layers": kv,
                                            "pos": pos + x.shape[1]}

    return Model(cfg, _init_lm(cfg, _stacked(init_transformer_block, cfg,
                                             cfg.num_layers)),
                 loss, prefill, decode_step, init_cache)


# ================================================================ pure SSM LM
def build_ssm_lm(cfg: ModelConfig, kernel: str = "auto") -> Model:
    """The attention-free Mamba2 LM."""

    def loss(params, batch):
        x = _embed_tokens(params, batch["tokens"], cfg)
        x, _ = ssm_stack(x, params["layers"], cfg, kernel=kernel)
        l = cross_entropy(_lm_logits(x, params, cfg), batch["labels"])
        return l, {"loss": l}

    def init_cache(batch, max_seq, device="cuda"):
        return {"layers": _ssm_states_zeros(cfg, batch,
                                            resolve_device(device)),
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

    return Model(cfg, _init_lm(cfg, _stacked(init_mamba_layer, cfg,
                                             cfg.num_layers)),
                 loss, prefill, decode_step, init_cache)


# ============================================================ hybrid (zamba2)
def build_hybrid_lm(cfg: ModelConfig, kernel: str = "auto") -> Model:
    """Mamba2 layers in groups of ``hybrid_period``, each group followed
    by one of ``num_shared_blocks`` shared attention blocks (cycled)."""
    G = cfg.num_layers // cfg.hybrid_period

    def init_layers(generator):
        return {"mamba": _stacked(init_mamba_layer, cfg,
                                  cfg.num_layers)(generator),
                "shared": _stacked(init_transformer_block, cfg,
                                   cfg.num_shared_blocks)(generator)}

    def loss(params, batch):
        x = _embed_tokens(params, batch["tokens"], cfg)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _, _ = hybrid_stack(x, params["layers"], cfg, positions=positions,
                               kernel=kernel)
        l = cross_entropy(_lm_logits(x, params, cfg), batch["labels"])
        return l, {"loss": l}

    def init_cache(batch, max_seq, device="cuda"):
        dev = resolve_device(device)
        return {"ssm": _ssm_states_zeros(cfg, batch, dev),
                "attn": _kv_cache_zeros(cfg, G, batch, max_seq, dev),
                "pos": 0}

    def prefill(params, batch, cache):
        x = _embed_tokens(params, batch["tokens"], cfg)
        positions = torch.arange(x.shape[1], device=x.device)
        x, ssm, kv = hybrid_stack(x, params["layers"], cfg,
                                  positions=positions,
                                  ssm_states=cache["ssm"],
                                  attn_cache=cache["attn"], cache_pos=0,
                                  kernel=kernel)
        logits = _lm_logits(x[:, -1:, :], params, cfg)
        return logits, {"ssm": ssm, "attn": kv, "pos": x.shape[1]}

    def decode_step(params, cache, batch):
        pos = cache["pos"]
        x = _embed_tokens(params, batch["tokens"], cfg)
        positions = torch.arange(pos, pos + x.shape[1], device=x.device)
        x, ssm, kv = hybrid_stack(x, params["layers"], cfg,
                                  positions=positions,
                                  ssm_states=cache["ssm"],
                                  attn_cache=cache["attn"], cache_pos=pos,
                                  decode=True, kernel=kernel)
        return _lm_logits(x, params, cfg), {"ssm": ssm, "attn": kv,
                                            "pos": pos + 1}

    return Model(cfg, _init_lm(cfg, init_layers), loss, prefill,
                 decode_step, init_cache)


# ============================================================ whisper enc-dec
def build_encdec(cfg: ModelConfig, kernel: str = "auto") -> Model:
    """Whisper-style: the stub conv frontend supplies (B, encoder_seq, D)
    frames; a non-causal encoder, a causal decoder with cross-attention."""

    def init(generator: torch.Generator, device="cuda"):
        dev = resolve_device(device)
        D = cfg.d_model
        p = {"embed": embed_init(generator, cfg.vocab_size, D),
             "enc_pos": 0.02 * torch.randn((cfg.encoder_seq, D),
                                           generator=generator,
                                           device=generator.device),
             "enc_layers": _stacked(init_transformer_block, cfg,
                                    cfg.encoder_layers)(generator),
             "enc_norm": norm_params(D, cfg),
             "dec_layers": _stacked_init(
                 lambda g: init_transformer_block(g, cfg, cross=True),
                 generator, cfg.num_layers),
             "final_norm": norm_params(D, cfg),
             "lm_head": dense_init(generator, D, cfg.vocab_size)}
        return tree_map(lambda t: t.to(dev), p)

    def encode(params, batch):
        x = batch["audio_embeds"].to(_adt(cfg)) + \
            params["enc_pos"].to(_adt(cfg))[None]
        x, _, _ = dense_stack(x, params["enc_layers"], cfg, positions=None,
                              mask=True, kernel=kernel)
        return apply_norm(x, params["enc_norm"], cfg)

    def decode_stack(x, params, positions, cross_k, cross_v, cache=None,
                     cache_pos=None):
        """The decoder layers; layer i attends to (cross_k[i],
        cross_v[i]). ``cache``: None (training) or the self-attention
        KV cache, written in place."""
        for i, (p, kv) in enumerate(_layers(params["dec_layers"], cache)):
            cross = (cross_k[i], cross_v[i])
            if kv is None and _remat(cfg):
                x, _, _ = checkpoint(transformer_block, x, p, cfg,
                                     positions, cross=cross, kernel=kernel,
                                     use_reentrant=False)
            else:
                x, _, _ = transformer_block(x, p, cfg, positions,
                                            kv_cache=kv, cache_pos=cache_pos,
                                            cross=cross, kernel=kernel)
        return x

    def loss(params, batch):
        enc = encode(params, batch)
        cross = [cross_kv(enc, p["cross_attn"], cfg)
                 for p, _ in _layers(params["dec_layers"])]
        x = _embed_tokens(params, batch["tokens"], cfg)
        positions = torch.arange(x.shape[1], device=x.device)
        x = decode_stack(x, params, positions, [k for k, _ in cross],
                         [v for _, v in cross])
        l = cross_entropy(_lm_logits(x, params, cfg), batch["labels"])
        return l, {"loss": l}

    def init_cache(batch, max_seq, device="cuda"):
        dev = resolve_device(device)
        cross = (cfg.num_layers, batch, cfg.encoder_seq, cfg.num_kv_heads,
                 cfg.head_dim)
        return {"layers": _kv_cache_zeros(cfg, cfg.num_layers, batch,
                                          max_seq, dev),
                "cross": {"k": torch.zeros(cross, dtype=_adt(cfg),
                                           device=dev),
                          "v": torch.zeros(cross, dtype=_adt(cfg),
                                           device=dev)},
                "pos": 0}

    def prefill(params, batch, cache):
        """Encodes once and writes every decoder layer's cross K/V into
        ``cache["cross"]`` (recomputing them per decode token would cost
        ~100x the useful decode work), then the decoder's prefill."""
        enc = encode(params, batch)
        ck, cv = cache["cross"]["k"], cache["cross"]["v"]
        for i, (p, _) in enumerate(_layers(params["dec_layers"])):
            k, v = cross_kv(enc, p["cross_attn"], cfg)
            ck[i].copy_(k)
            cv[i].copy_(v)
        x = _embed_tokens(params, batch["tokens"], cfg)
        positions = torch.arange(x.shape[1], device=x.device)
        x = decode_stack(x, params, positions, ck, cv, cache=cache["layers"],
                         cache_pos=0)
        logits = _lm_logits(x[:, -1:, :], params, cfg)
        return logits, {"layers": cache["layers"], "cross": cache["cross"],
                        "pos": x.shape[1]}

    def decode_step(params, cache, batch):
        pos = cache["pos"]
        x = _embed_tokens(params, batch["tokens"], cfg)
        positions = torch.arange(pos, pos + x.shape[1], device=x.device)
        x = decode_stack(x, params, positions, cache["cross"]["k"],
                         cache["cross"]["v"], cache=cache["layers"],
                         cache_pos=pos)
        return _lm_logits(x, params, cfg), {"layers": cache["layers"],
                                            "cross": cache["cross"],
                                            "pos": pos + 1}

    return Model(cfg, init, loss, prefill, decode_step, init_cache)


FAMILIES = {"dense": build_lm, "moe": build_lm, "vlm": build_lm,
            "ssm": build_ssm_lm, "hybrid": build_hybrid_lm,
            "audio": build_encdec}


def build_model(cfg: ModelConfig, kernel: str = "auto") -> Model:
    mode.check_kernel_mode(kernel, "cuda")
    if cfg.family not in FAMILIES:
        raise ValueError(
            f"family {cfg.family!r} is not an LM family of the zoo; "
            f"build_model builds {sorted(FAMILIES)}")
    return FAMILIES[cfg.family](cfg, kernel)


class _MetaDraws(torch.Generator):
    """A CPU generator whose draws land on the meta device: every ``init``
    allocates its draws on ``generator.device``, and a draw into a meta
    tensor computes nothing."""

    @property
    def device(self):
        return torch.device("meta")


def param_specs(cfg: ModelConfig):
    """The parameter tree ``build_model(cfg).init`` returns, as meta tensors
    of the same shapes and dtypes: nothing is drawn or allocated (``init``
    itself draws on its generator's device before moving the tree, which
    for internvl2-76b would be 282 GB on the host)."""
    with torch.device("meta"):
        return build_model(cfg, kernel="reference").init(_MetaDraws(),
                                                         device="meta")


def params_from_jax(tree, device="cuda"):
    """A JAX parameter tree (nested dicts of numpy or jax arrays) as the
    port's tree of tensors on ``device``, dtypes and the stacked leading
    layer dimension kept."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(dev)
