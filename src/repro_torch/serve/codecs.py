"""Per-shard wire codecs for push ingestion — the counterpart of
``repro/serve/codecs.py``, built on ``optim/compression.py``.

A push travels as one packet per shard; the codec decides what the
packet's payload is. Encoding happens client-side (so stateful codecs
keep their accumulators per ``(client, shard)`` key), decoding happens in
the ingestion pipeline before the shard is staged.

- ``none``   raw f32 slice (4 B/param).
- ``int8``   symmetric int8 quantization of the full slice: 1 B/param +
             one scale, error bounded by scale/2 per entry, no base
             needed.
- ``topk``   top-k sparsified DELTA against the base the client pulled,
             with per-(client, shard) error feedback: ~``ratio`` of the
             slice travels; the decoder reconstructs against the same
             base via the server's version history ring, so the wire
             carries the client's ``base_version``.

Codecs with ``needs_base=True`` require the decoder to resolve the
client's base slice (history ring lookup, ``ShardedAsyncParameterServer.
base_shard``); a ring miss falls back to the current slice — counted,
approximate, never fatal.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..optim.compression import (TopK, int8_dequantize, int8_quantize,
                                 topk_compress, topk_decompress)

__all__ = ["ShardCodec", "NullCodec", "Int8Codec", "TopKDeltaCodec",
           "resolve_codec", "registered_codecs"]


class ShardCodec:
    """Base codec: ``encode`` runs client-side, ``decode`` server-side.

    ``key`` identifies the (client, shard) stream for stateful codecs;
    ``base`` is the client's pulled base slice (encode) / the ring-
    resolved base slice (decode) and is only consulted when
    ``needs_base`` is set."""

    name: str = ""
    needs_base: bool = False

    def encode(self, key: Tuple[int, int], new: torch.Tensor,
               base: Optional[torch.Tensor] = None) -> Any:
        raise NotImplementedError

    def decode(self, payload: Any,
               base: Optional[torch.Tensor] = None) -> torch.Tensor:
        raise NotImplementedError

    def wire_bytes(self, payload: Any) -> int:
        """Approximate on-the-wire size of one payload (bench column)."""
        raise NotImplementedError

    def reset(self) -> None:
        """Drop any per-stream accumulator state."""


class NullCodec(ShardCodec):
    name = "none"

    def encode(self, key, new, base=None):
        return new.float()

    def decode(self, payload, base=None):
        return payload

    def wire_bytes(self, payload):
        return 4 * payload.numel()


class Int8Codec(ShardCodec):
    name = "int8"

    def encode(self, key, new, base=None):
        return int8_quantize(new)

    def decode(self, payload, base=None):
        q, scale = payload
        return int8_dequantize(q, scale)

    def wire_bytes(self, payload):
        q, _ = payload
        return q.numel() + 4


class TopKDeltaCodec(ShardCodec):
    """Top-k + error feedback on the delta stream ``new - base``."""

    name = "topk"
    needs_base = True

    def __init__(self, ratio: float = 0.01, min_k: int = 1):
        if not 0.0 < ratio <= 1.0:
            raise ValueError(f"ratio must be in (0, 1], got {ratio}")
        self.ratio = float(ratio)
        self.min_k = int(min_k)
        self._residual: Dict[Tuple[int, int], torch.Tensor] = {}

    def encode(self, key, new, base=None):
        if base is None:
            raise ValueError("topk delta codec needs the pulled base slice")
        delta = new.float() - base.float()
        r = self._residual.get(key)
        corrected = delta if r is None else delta + r
        k = max(int(math.prod(corrected.shape) * self.ratio), self.min_k)
        payload = topk_compress(corrected, k)
        self._residual[key] = corrected - topk_decompress(payload)
        return payload

    def decode(self, payload: TopK, base=None):
        if base is None:
            raise ValueError("topk delta codec needs the base slice to "
                             "reconstruct (history-ring lookup)")
        return base.float() + topk_decompress(payload)

    def wire_bytes(self, payload: TopK):
        return 8 * payload.values.numel()    # 4 B value + 4 B index

    def reset(self):
        self._residual.clear()


_CODECS = {cls.name: cls for cls in (NullCodec, Int8Codec, TopKDeltaCodec)}


def registered_codecs() -> Tuple[str, ...]:
    return tuple(_CODECS)


def resolve_codec(codec: Union[str, ShardCodec, None]) -> ShardCodec:
    if codec is None:
        return NullCodec()
    if isinstance(codec, ShardCodec):
        return codec
    if isinstance(codec, str):
        if codec not in _CODECS:
            raise ValueError(f"unknown codec {codec!r}; expected one of "
                             f"{registered_codecs()} or a ShardCodec")
        return _CODECS[codec]()
    raise ValueError(f"codec must be a name or ShardCodec, got "
                     f"{type(codec).__name__}")
