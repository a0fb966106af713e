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


# Largest float32 draw of one piece (4 GiB): a leaf whose draw would be
# larger is drawn piece by piece along its leading axes (deepseek-v3's
# stacked expert weight [2, 256, 7168, 2048] would be a 30 GB float32
# temporary beside 36 GB of weights already on the 80 GB of an NVIDIA H100
# 80GB HBM3, 700 W).
MAX_DRAW_BYTES = 1 << 32


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
    # piece by piece: the leaf flattened to [rows, inner], inner the largest
    # block of trailing axes whose draw fits, and each piece whole rows (a
    # leaf within the limit is one piece: one draw of the whole leaf)
    limit = MAX_DRAW_BYTES
    out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
    k = next((k for k in range(1, len(spec.shape))
              if 4 * int(np.prod(spec.shape[k:])) <= limit), len(spec.shape) - 1)
    flat = out.view(-1, int(np.prod(spec.shape[k:])))
    step = max(1, limit // (4 * flat.shape[1]))
    for r in range(0, flat.shape[0], step):
        piece = flat[r:r + step]
        x = torch.randn(piece.shape, generator=generator, dtype=torch.float32,
                        device=device)
        # scaled in place: no scaled float32 copy beside the draw
        piece.copy_(x.mul_(std))
        del x
    return out


def materialize(tree, generator: torch.Generator, device):
    """ParamSpec tree → tensor tree on ``device``, drawn leaf by leaf from
    ``generator`` (which must live on ``device``).  Each leaf is drawn in
    pieces of whole rows along its leading axes, none of whose float32 draw
    exceeds ``MAX_DRAW_BYTES``, each scaled in place and cast into the leaf,
    so a model near the card's memory never holds a leaf-sized float32
    temporary; a leaf within the limit is one draw."""
    return tree_map(lambda s: _init_one(s, generator, device), tree)


def count_params(tree) -> int:
    total = 0

    def add(s: ParamSpec):
        nonlocal total
        total += int(np.prod(s.shape))

    tree_map(add, tree)
    return total
