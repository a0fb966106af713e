"""Logical-axis sharding-constraint context, the port of the JAX package's
``nn/pcontext.py``.

Layers are mesh-agnostic; drivers that *do* know the mesh activate
``logical_sharding(mesh, rules)`` and layer code can then pin critical
intermediates (the per-layer param slices, the activation carry, the MoE
dispatch buffer, recurrent carries) with ``constrain(x, logical_axes)``.
Where the reference's ``with_sharding_constraint`` asks the partitioner for
a layout, ``constrain`` redistributes a DTensor to the rule's placements
(the collectives this takes are the ones the dry-run counts).  Outside the
context, and on a plain tensor, ``constrain`` is the identity, so tests and
single-device code never touch sharding machinery.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence

import torch

from repro_torch.nn.module import axis_sizes, logical_to_pspec, placements

__all__ = ["logical_sharding", "constrain", "active", "is_dtensor", "reshape",
           "contiguous_grad", "rule_placements", "block_placements", "to_block", "from_block",
           "collective_scope", "current_scope"]

_ACTIVE: list = []


@contextlib.contextmanager
def logical_sharding(mesh, rules: Dict[str, object]):
    """Pin ``constrain``'s call sites to ``rules`` on ``mesh`` (a
    ``DeviceMesh``) inside the block."""
    _ACTIVE.append((mesh, rules))
    try:
        yield
    finally:
        _ACTIVE.pop()


_SCOPE: list = []


@contextlib.contextmanager
def collective_scope(name: str):
    """Name the collectives run inside the block (``launch/hlo.py
    CostCounter`` tallies their payloads under the innermost name)."""
    _SCOPE.append(name)
    try:
        yield
    finally:
        _SCOPE.pop()


def current_scope() -> str:
    """The innermost ``collective_scope`` name, or ``"other"``."""
    return _SCOPE[-1] if _SCOPE else "other"


def active():
    """The innermost (mesh, rules) of ``logical_sharding``, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


_DTENSOR: list = []


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (``torch.distributed.tensor`` is imported
    on the first call, not with this module)."""
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor
        _DTENSOR.append(DTensor)
    return isinstance(x, _DTENSOR[0])


def constrain(x: torch.Tensor, logical_axes: Sequence[Optional[str]]) -> torch.Tensor:
    """``x`` redistributed to the placements of ``logical_axes`` under the
    active rules.  A dim that its mesh axes do not divide stays unsharded
    (DTensor would shard it unevenly; the reference's partitioner pads)."""
    if not _ACTIVE or not is_dtensor(x):
        return x
    mesh = _ACTIVE[-1][0]
    want = rule_placements(x.shape, logical_axes)
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(mesh, want)


def rule_placements(shape, logical_axes: Sequence[Optional[str]]):
    """The DTensor placements that ``constrain`` gives a tensor of ``shape``
    under the active rules (a dim its mesh axes do not divide unsharded)."""
    mesh, rules = _ACTIVE[-1]
    spec = list(logical_to_pspec(tuple(logical_axes), rules))
    sizes = axis_sizes(mesh)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else entry
        n = 1
        for a in axes:
            n *= sizes[a]
        if shape[d] % n:
            spec[d] = None
    return placements(spec, mesh)


def block_placements(x, n_channels: int, chan_dim: Optional[int], batch: bool = True):
    """Placements of a per-rank block for a recurrence or a decode over
    DTensor ``x [B, ...]`` (the block's input): the batch axis 0 sharded as
    ``x``'s is (none with ``batch=False``), axis ``chan_dim`` (heads or
    channels, ``n_channels`` of them) over the mesh's ``model`` axis where
    that divides them, every other axis whole.  A recurrence is local in
    batch and channel, so each rank runs its block with no collective."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    names = list(mesh.mesh_dim_names or ())
    out = []
    for i, p in enumerate(x.placements):
        if batch and isinstance(p, Shard) and p.dim == 0:
            out.append(Shard(0))
        elif (chan_dim is not None and i < len(names) and names[i] == "model"
              and n_channels % mesh.size(i) == 0):
            out.append(Shard(chan_dim))
        else:
            out.append(Replicate())
    return tuple(out)


def to_block(x: torch.Tensor, mesh, pl, work=None) -> torch.Tensor:
    """This rank's local block of ``x`` under placements ``pl``: a DTensor
    is redistributed and unwrapped, a plain tensor, replicated by
    implication, is sliced.  ``work``: the placements of the computation the
    block enters (those of its batch- and channel-split tensors); on a mesh
    dim that splits the work but replicates ``x`` (a weight without a batch
    axis, a tensor without a channel axis) each rank's gradient is a
    partial sum.  The gradient comes back contiguous."""
    if is_dtensor(x):
        from torch.distributed.tensor import Partial, Replicate, Shard

        grad = tuple(Partial() if work is not None and isinstance(w, Shard)
                     and isinstance(p, Replicate) else p for p, w in zip(pl, work or pl))
        return contiguous_grad(x.redistribute(mesh, pl).to_local(grad_placements=grad))
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    local, off = compute_local_shape_and_global_offset(x.shape, mesh, pl)
    return x[tuple(slice(o, o + n) for o, n in zip(off, local))]


def from_block(local: torch.Tensor, mesh, pl, shape) -> torch.Tensor:
    """A DTensor of global ``shape`` whose local block under placements
    ``pl`` is ``local`` (made contiguous, as DTensor's view rules assume)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local.contiguous(), mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``, computed without
    making one (a meta tensor of a global shape would count as live memory
    under a cost counter)."""
    stride, step = [], 1
    for n in reversed(tuple(shape)):
        stride.append(step)
        step *= max(int(n), 1)
    return tuple(reversed(stride))


def _local_contiguous(x):
    """A DTensor whose local shard is contiguous, as DTensor's view rules
    assume (``DTensor.contiguous`` looks at the global strides only)."""
    from torch.distributed.tensor import DTensor

    local = x.to_local()
    if local.is_contiguous():
        return x
    return DTensor.from_local(local.contiguous(), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape, stride=x.stride())


def _reshape_dtensor(x, shape):
    x = _local_contiguous(x)
    try:
        return x.reshape(*shape)
    except RuntimeError:
        from torch.distributed.tensor import Replicate, Shard

        shape = list(shape)
        if -1 in shape:
            known = 1
            for s in shape:
                known *= s if s != -1 else 1
            shape[shape.index(-1)] = x.numel() // known
        first = next((i for i, (a, b) in enumerate(zip(x.shape, shape)) if a != b),
                     min(x.dim(), len(shape)))
        want = [Replicate() if isinstance(p, Shard) and p.dim >= first else p
                for p in x.placements]
        return _local_contiguous(x.redistribute(x.device_mesh, want)).reshape(*shape)


class _Reshape(torch.autograd.Function):
    """A DTensor reshape whose backward reshapes the gradient the same way
    (gathering what the gradient's sharding cannot carry)."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.in_shape = tuple(x.shape)
        return _reshape_dtensor(x, shape)

    @staticmethod
    def backward(ctx, g):
        return _reshape_dtensor(g, ctx.in_shape), None


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous gradient."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def contiguous_grad(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose gradient arrives contiguous: a local block wrapped into
    a DTensor (``DTensor.from_local``) may get back a strided gradient that
    the local ops' backward cannot ``view``."""
    return _ContiguousGrad.apply(x)


def reshape(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x.reshape(*shape)``.  On a DTensor whose sharded dims the reshape
    cannot carry (a flattened ``H·D`` sharded 16 ways split into 24 heads),
    the dims from the first one the reshape changes are gathered first, in
    the forward and in the backward — collectives the dry-run counts, where
    the reference's partitioner would insert its own."""
    if not is_dtensor(x):
        return x.reshape(*shape)
    return _Reshape.apply(x, shape)
