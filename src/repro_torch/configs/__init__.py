"""Architecture registry of the port: ``get_config(arch_id)`` /
``get_smoke_config(arch_id)``, the counterpart of ``repro/configs``.

The port has the architectures whose family it builds (``models/zoo.py``):
the dense ``qwen3-0.6b``, ``qwen2.5-3b``, ``phi4-mini-3.8b`` and
``internlm2-20b``, the MoE ``granite-moe-1b-a400m`` and
``qwen3-moe-30b-a3b``, and the SSM ``mamba2-370m``, each under its
assigned id, its module name and the module name with dashes (the JAX
registry's aliases). Every other id of the JAX registry is still to port
and raises (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import importlib

_IDS = {"qwen3-0.6b": "qwen3_0_6b", "mamba2-370m": "mamba2_370m",
        "qwen2.5-3b": "qwen2_5_3b", "phi4-mini-3.8b": "phi4_mini_3_8b",
        "internlm2-20b": "internlm2_20b",
        "granite-moe-1b-a400m": "granite_moe_1b_a400m",
        "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b"}
ALIASES = {alias: mod for arch, mod in _IDS.items()
           for alias in (arch, mod, mod.replace("_", "-"))}


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
