"""The LM cells' input shapes, as meta tensors — the counterpart of
``repro/launch/shapes.py``.

Shapes (LM family, seq_len x global_batch):
    train_4k     4,096 x 256   -> train_step
    prefill_32k  32,768 x 32   -> prefill_step (serve)
    decode_32k   32,768 x 128  -> decode_step (1 new token, KV cache of 32k)
    long_500k    524,288 x 1   -> decode_step; only for sub-quadratic archs
                                  (mamba2, zamba2)

``input_specs`` returns ``torch.empty(..., device="meta")`` tensors where
the JAX module returns ``jax.ShapeDtypeStruct``s: shapes and dtypes, no
allocation. The cache's ``pos`` is a Python int here (the port's models
carry it so) where JAX has a 0-d int32.

``FSDP_ARCHS``, ``FSDP_SERVE_ARCHS`` and the ``shard_activations``
override are the JAX module's, kept so that a cell's
``config_overrides`` read as JAX's do; none of them changes anything on
one card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# train_4k's microbatches: the step accumulates gradients over 8 of 32
# sequences each
TRAIN_MICROBATCHES = 8

# the JAX module's FSDP sets (train cells; serving cells): sharding
# choices of the TPU meshes, recorded only
FSDP_ARCHS = {"qwen3-moe-30b-a3b", "internlm2-20b", "internvl2-76b",
              "granite-moe-1b-a400m", "phi4-mini-3.8b", "whisper-large-v3"}
FSDP_SERVE_ARCHS = {"internvl2-76b", "internlm2-20b"}


def applicable(cfg, shape: str) -> bool:
    """long_500k only for sub-quadratic (O(1)-state decode) archs."""
    if shape == "long_500k":
        return cfg.sub_quadratic
    return True


def production_config(cfg, shape: str):
    """The cell's overrides, as JAX's: chunked attention for 4k+ sequence
    train and prefill work (the einsum route would materialise (Sq, Sk)
    scores), and ``shard_activations`` for the wide (d_model >= 3072)
    train cells. Returns (cfg with them, the overrides)."""
    spec = SHAPES[shape]
    over = {}
    if cfg.num_heads and spec.kind in ("train", "prefill") \
            and spec.seq_len >= 4096:
        over["attention_impl"] = "chunked"
    if spec.kind == "train" and cfg.d_model >= 3072:
        over["shard_activations"] = True
    return (dataclasses.replace(cfg, **over) if over else cfg), over


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg, spec: ShapeSpec, *,
                microbatches: int = 1) -> Dict[str, Any]:
    """The token batch a step consumes (train/prefill); decode uses 1
    token. The audio and VLM frontends are stubs: precomputed f32 frame
    and patch embeddings."""
    B, S = spec.global_batch, spec.seq_len
    if spec.kind == "train":
        M = microbatches
        assert B % M == 0
        lead = (M, B // M) if M > 1 else (B,)
    else:
        lead = (B,)
    if spec.kind == "decode":
        batch = {"tokens": _meta(lead + (1,), torch.int32)}
    else:
        batch = {"tokens": _meta(lead + (S,), torch.int32)}
        if spec.kind == "train":
            batch["labels"] = _meta(lead + (S,), torch.int32)
    if cfg.family == "audio" and spec.kind != "decode":
        batch["audio_embeds"] = _meta(lead + (cfg.encoder_seq, cfg.d_model),
                                      torch.float32)
    if cfg.family == "vlm" and spec.kind != "decode":
        batch["vision_embeds"] = _meta(
            lead + (cfg.num_vision_tokens, cfg.d_model), torch.float32)
    return batch


def cache_specs(cfg, spec: ShapeSpec):
    """The decode cache (KV / SSM state) at seq_len, on meta."""
    from ..models import build_model
    return build_model(cfg).init_cache(
        spec.global_batch, spec.seq_len, device="meta")


def input_specs(cfg, shape, *, microbatches: int | None = None):
    """Returns (kind, kwargs dict of meta tensors) for the step function.
    ``shape`` is a shape name or a ShapeSpec."""
    spec = SHAPES[shape] if isinstance(shape, str) else shape
    if spec.kind == "train":
        M = TRAIN_MICROBATCHES if microbatches is None else microbatches
        return "train", {"batch": batch_specs(cfg, spec, microbatches=M)}
    if spec.kind == "prefill":
        return "prefill", {"batch": batch_specs(cfg, spec),
                           "cache": cache_specs(cfg, spec)}
    return "decode", {"cache": cache_specs(cfg, spec),
                      "batch": batch_specs(cfg, spec)}
