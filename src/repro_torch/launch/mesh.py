"""Production mesh + sharding rule tables, the port of the JAX package's
``launch/mesh.py``.

``make_production_mesh`` is a function, so importing this module never
touches ``torch.distributed``: a mesh is built on the default process group,
which the caller (the training CLI, the dry-run, a test) has initialised
with its own world size.

Rule tables map *logical* axes (``nn/module.py`` ParamSpec) → mesh axes:

* train/prefill — TP on ``model`` (heads/mlp/experts/vocab), FSDP on
  ``data`` (+``pod`` when present) for the embed dimension; batch on
  data(+pod).
* decode — the same parameter layout; KV caches shard batch on data(+pod)
  and sequence on ``model`` (flash-decode style).

1-D params (norm gains, biases) are always replicated.

Every function that reads a mesh takes a ``DeviceMesh`` or any stand-in
with JAX's ``axis_names`` and ``shape`` mapping (``nn.module.axis_sizes``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.nn.module import P, ParamSpec, axis_sizes, logical_to_pspec, placements
from repro_torch.tree import tree_map

__all__ = [
    "make_production_mesh",
    "make_mesh",
    "sharding_rules",
    "param_pspecs",
    "param_shardings",
    "batch_axes",
]


def _mk(shape: Tuple[int, ...], axes: Tuple[str, ...], device_type: Optional[str] = None):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = int(np.prod(shape))
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, the default process group has {world} — "
            "initialise torch.distributed with the mesh's world size first (the "
            "dry-run does, on a fake process group)")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: Optional[str] = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mk(shape, axes, device_type)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: Optional[str] = None):
    """Arbitrary mesh (tests, elastic re-shard targets) over the first
    ``prod(shape)`` ranks of the default group."""
    return _mk(tuple(shape), tuple(axes), device_type)


def batch_axes(mesh):
    """Mesh axes the global batch shards over."""
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def sharding_rules(mesh, kind: str = "train", **overrides) -> Dict[str, object]:
    """Logical-axis → mesh-axis table for ``kind`` ∈ {train, prefill, decode}.

    ``act_seq`` governs the layer-boundary activation carry
    (``models/lm.py``): sharding it on ``model`` is Megatron-style sequence
    parallelism, on for train and prefill as in the reference.
    """
    multi = "pod" in axis_sizes(mesh)
    fsdp = ("pod", "data") if multi else ("data",)
    rules: Dict[str, object] = {
        "batch": fsdp,
        "embed": fsdp,            # FSDP: weight rows sharded over data(+pod)
        "embed2": None,
        "heads_flat": "model",    # TP: flattened H·D
        "mlp": "model",
        "experts": "model",       # EP: routed experts over model
        "vocab": "model",
        "layers": None,           # stacked layer axis — never sharded
        "seq": None,
        "act_seq": "model" if kind in ("train", "prefill") else None,
        "kv_seq": "model",        # decode caches: sequence-sharded (flash-decode)
        "capacity": fsdp,         # MoE dispatch buffer token axis
    }
    rules.update(overrides)
    return rules


def param_pspecs(spec_tree, rules: Dict[str, object], mesh=None):
    """ParamSpec tree → partition spec tree; 1-D params replicated.

    With ``mesh`` given, any dim not divisible by its assigned mesh axes is
    left unsharded (e.g. hymba's vocab 32001).
    """

    def one(s: ParamSpec):
        if len(s.shape) <= 1:
            return P()
        spec = logical_to_pspec(s.logical_axes, rules)
        if mesh is None:
            return spec
        sizes = axis_sizes(mesh)
        entries = list(spec) + [None] * (len(s.shape) - len(spec))
        out = []
        for dim, ax in zip(s.shape, entries):
            axes = (ax,) if isinstance(ax, str) else (ax or ())
            size = int(np.prod([sizes[a] for a in axes])) if axes else 1
            out.append(ax if size and dim % size == 0 else None)
        while out and out[-1] is None:
            out.pop()
        return P(*out)

    return tree_map(one, spec_tree)


def param_shardings(spec_tree, mesh, rules: Dict[str, object]):
    """DTensor placements of every param on ``mesh``.  As in the reference,
    the specs come from ``param_pspecs`` without the mesh, so no
    non-dividing axis is dropped."""
    return tree_map(lambda p: placements(p, mesh), param_pspecs(spec_tree, rules),
                    is_leaf=lambda x: isinstance(x, P))
