"""Parameter specs and their initialisation.

A model builds a tree of :class:`ParamSpec` descriptors (the same tree, with
the same logical axis names, as the JAX package's ``param_spec``);
:func:`materialize` turns it into tensors on a device.  The init rules are the
JAX package's: ``normal`` draws N(0, 0.02·scale), ``fan_in`` draws
N(0, scale²/fan_in), ``ones`` and ``zeros`` are constant.  The draws come from
a ``torch.Generator`` and so differ from ``jax.random``'s; parity tests carry
the JAX package's weights across with :mod:`repro_torch.bridge` instead.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_map

__all__ = ["ParamSpec", "materialize", "count_params"]


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical_axes: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"          # normal | zeros | ones | fan_in
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.logical_axes):
            raise ValueError((self.shape, self.logical_axes))


def _init_one(spec: ParamSpec, generator: torch.Generator, device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "fan_in":
        fan_in = spec.shape[0] if len(spec.shape) <= 2 else int(np.prod(spec.shape[:-1]))
        std = spec.scale / math.sqrt(max(fan_in, 1))
    else:
        std = 0.02 * spec.scale
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=device)
    # scaled in place: the float32 draw of a stacked expert weight is 26 GB
    # at 8 of qwen3-moe's layers, and a scaled copy beside it and the model
    # would not fit on one 80 GB card
    return x.mul_(std).to(spec.dtype)


def materialize(tree, generator: torch.Generator, device):
    """ParamSpec tree → tensor tree on ``device``, drawn leaf by leaf from
    ``generator`` (which must live on ``device``)."""
    return tree_map(lambda s: _init_one(s, generator, device), tree)


def count_params(tree) -> int:
    total = 0

    def add(s: ParamSpec):
        nonlocal total
        total += int(np.prod(s.shape))

    tree_map(add, tree)
    return total
