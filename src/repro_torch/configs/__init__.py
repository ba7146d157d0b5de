"""Architecture registry of the port: ``get_config(arch_id)`` /
``get_smoke_config(arch_id)``, the counterpart of ``repro/configs``.

Every architecture of the JAX registry, under its assigned id, its module
name and the module name with dashes (the JAX registry's aliases): the
dense ``qwen3-0.6b``, ``qwen2.5-3b``, ``phi4-mini-3.8b`` and
``internlm2-20b``, the MoE ``granite-moe-1b-a400m`` and
``qwen3-moe-30b-a3b``, the SSM ``mamba2-370m``, the hybrid
``zamba2-2.7b``, the audio ``whisper-large-v3``, the VLM
``internvl2-76b``, and ``paper-lenet5`` (the paper's LeNet-5 workload:
not an LM config, so ``build_model`` does not take it). An unknown id
raises.

``ARCHS`` is the JAX registry's list of module names, in its order, and
``all_arch_ids()`` the ids that registry derives from it, letter for
letter: zamba2's comes out as ``zamba2-2-7b`` (module name with dashes,
not its assigned ``zamba2-2.7b``), an alias ``get_config`` accepts.
"""
from __future__ import annotations

import importlib

_IDS = {"qwen3-0.6b": "qwen3_0_6b", "mamba2-370m": "mamba2_370m",
        "qwen2.5-3b": "qwen2_5_3b", "phi4-mini-3.8b": "phi4_mini_3_8b",
        "internlm2-20b": "internlm2_20b",
        "granite-moe-1b-a400m": "granite_moe_1b_a400m",
        "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
        "zamba2-2.7b": "zamba2_2_7b",
        "whisper-large-v3": "whisper_large_v3",
        "internvl2-76b": "internvl2_76b",
        "paper-lenet5": "paper_lenet5"}
ARCHS = ["mamba2_370m", "qwen3_moe_30b_a3b", "granite_moe_1b_a400m",
         "internlm2_20b", "qwen3_0_6b", "qwen2_5_3b", "phi4_mini_3_8b",
         "whisper_large_v3", "zamba2_2_7b", "internvl2_76b"]
ALIASES = {alias: mod for arch, mod in _IDS.items()
           for alias in (arch, mod, mod.replace("_", "-"))}


def _module(arch: str):
    if arch not in ALIASES:
        raise KeyError(f"unknown architecture {arch!r}; the registry has "
                       f"{sorted(_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{ALIASES[arch]}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).SMOKE_CONFIG


def all_arch_ids():
    dotted = {"qwen3_0_6b": "qwen3-0.6b", "qwen2_5_3b": "qwen2.5-3b",
              "phi4_mini_3_8b": "phi4-mini-3.8b"}
    return [dotted.get(a, a.replace("_", "-")) for a in ARCHS]
