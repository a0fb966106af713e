"""Architecture registry of the port: ``--arch <id>`` → ModelConfig.

Only the architectures whose whole serving path is ported are listed; every
other id of the JAX package's registry raises ``NotImplementedError``.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ModelConfig

__all__ = ["ARCH_IDS", "get_config", "get_smoke"]

_MODULES = {
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "nemotron-4-15b": "repro_torch.configs.nemotron_4_15b",
    "phi3-medium-14b": "repro_torch.configs.phi3_medium_14b",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
}

ARCH_IDS: List[str] = list(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to PyTorch yet (ported: {ARCH_IDS}); "
            "see ROADMAP.md for the order of the remaining families")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
