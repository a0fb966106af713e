"""Parameter specs and their initialisation.

A model builds a tree of :class:`ParamSpec` descriptors (the same tree, with
the same logical axis names, as the JAX package's ``param_spec``);
:func:`materialize` turns it into tensors on a device, :func:`abstract` into
meta tensors of each leaf's shape and dtype (no memory), and
:func:`pspec_tree` into partition specs under a table of sharding rules, as
in the reference.  :func:`shardings` places a pspec on a ``DeviceMesh`` as
DTensor placements.  The init rules are the
JAX package's: ``normal`` draws N(0, 0.02·scale), ``fan_in`` draws
N(0, scale²/fan_in), ``ones`` and ``zeros`` are constant.  The draws come from
a ``torch.Generator`` and so differ from ``jax.random``'s; parity tests carry
the JAX package's weights across with :mod:`repro_torch.bridge` instead.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_map

__all__ = ["ParamSpec", "P", "abstract", "materialize", "logical_to_pspec", "pspec_tree",
           "axis_sizes", "placements", "shardings", "count_params"]


class P(tuple):
    """A partition spec: one entry per leading tensor dim, each a mesh axis
    name, a tuple of mesh axis names (major first) or None; trailing
    unsharded dims are dropped.  A plain tuple, entry for entry the JAX
    package's ``PartitionSpec``, which also spells a one-axis tuple entry
    as the axis and an empty one as None."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            (e[0] if len(e) == 1 else (e or None)) if isinstance(e, tuple) else e
            for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


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


def abstract(tree, device="meta"):
    """ParamSpec tree → tensors of each leaf's shape and dtype on ``device``
    (by default the meta device: nothing is allocated)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device=device), tree)


def logical_to_pspec(axes: Sequence[Optional[str]], rules: Dict[str, object]) -> P:
    """Map logical axes → partition spec under ``rules``, dropping repeats.

    A rule value may be a single mesh axis, a tuple of mesh axes (e.g.
    ``("data", "model")`` for fully-sharded giant tables), or None.  A mesh
    axis may not appear twice in one spec; later occurrences are dropped."""
    used: set = set()
    out: List[object] = []
    for ax in axes:
        m = rules.get(ax) if ax is not None else None
        if m is None:
            out.append(None)
            continue
        ms = (m,) if isinstance(m, str) else tuple(m)
        ms = tuple(x for x in ms if x not in used)
        if not ms:
            out.append(None)
        elif len(ms) == 1:
            out.append(ms[0])
            used.add(ms[0])
        else:
            out.append(ms)
            used.update(ms)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def pspec_tree(tree, rules: Dict[str, object]):
    return tree_map(lambda s: logical_to_pspec(s.logical_axes, rules), tree)


def axis_sizes(mesh) -> Dict[str, int]:
    """Mesh axis name → size, in the mesh's axis order, of a ``DeviceMesh``
    or of any stand-in with JAX's ``axis_names`` and ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def placements(spec: Sequence, mesh) -> Tuple[object, ...]:
    """A partition spec as DTensor placements on ``mesh`` (a
    ``DeviceMesh``): ``Shard(d)`` on every mesh dim named by entry ``d``,
    ``Replicate()`` on the others.  A tuple entry shards one tensor dim over
    several mesh dims, the first named major, as in JAX; they must come in
    the mesh's own order, which is DTensor's order of sharding."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: List[object] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's order {names}")
        for m in dims:
            out[m] = Shard(d)
    return tuple(out)


def shardings(tree, mesh, rules: Dict[str, object]):
    """ParamSpec tree → tree of DTensor placements on ``mesh`` under ``rules``."""
    return tree_map(lambda s: placements(logical_to_pspec(s.logical_axes, rules), mesh),
                    tree)


def count_params(tree) -> int:
    total = 0

    def add(s: ParamSpec):
        nonlocal total
        total += int(np.prod(s.shape))

    tree_map(add, tree)
    return total
