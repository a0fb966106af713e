"""Architecture registry of the port: ``--arch <id>`` → ModelConfig.

The JAX package's ten architectures, in its order, each with its published
config and its smoke config, and the dry-run's (arch × shape) cells: the
``long_500k`` cell needs sub-quadratic attention and runs only for the
SSM/hybrid archs; every arch is a decoder, so no other cell is skipped.
"""
from __future__ import annotations

import importlib
from typing import List, Optional, Tuple

from repro_torch.configs.base import LM_SHAPES, ModelConfig, ShapeConfig

__all__ = ["ARCH_IDS", "get_config", "get_smoke", "cells", "skip_reason"]

_MODULES = {
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b",
    "nemotron-4-15b": "repro_torch.configs.nemotron_4_15b",
    "phi3-medium-14b": "repro_torch.configs.phi3_medium_14b",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
}

ARCH_IDS: List[str] = list(_MODULES)

# Archs with sub-quadratic sequence mixing (run the long_500k cell).
SUBQUADRATIC = {"hymba-1.5b", "xlstm-350m"}


def get_config(arch: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch]).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch]).SMOKE


def skip_reason(arch: str, shape: str) -> Optional[str]:
    """None ⇒ the (arch × shape) cell runs; else why it is skipped."""
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return "long_500k needs sub-quadratic attention (full-attention arch; DESIGN.md §5)"
    return None


def cells() -> List[Tuple[str, ShapeConfig]]:
    """All runnable (arch, shape) dry-run cells (40 assigned minus skips)."""
    return [(arch, shape) for arch in ARCH_IDS for shape in LM_SHAPES.values()
            if skip_reason(arch, shape.name) is None]
