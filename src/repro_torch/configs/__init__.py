"""Architecture registry of the port: ``get_config(arch_id)`` /
``get_smoke_config(arch_id)``, the counterpart of ``repro/configs``.

The port has the architectures whose family it builds (``models/zoo.py``):
the dense ``qwen3-0.6b`` and the SSM ``mamba2-370m``. Every other id of
the JAX registry is still to port and raises (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import importlib

ALIASES = {"qwen3-0.6b": "qwen3_0_6b", "qwen3_0_6b": "qwen3_0_6b",
           "mamba2-370m": "mamba2_370m", "mamba2_370m": "mamba2_370m"}


def _module(arch: str):
    if arch not in ALIASES:
        raise NotImplementedError(
            f"architecture {arch!r} is not ported yet (ROADMAP Queue 1 "
            f"item 7); the port has {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{ALIASES[arch]}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).SMOKE_CONFIG
