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
           "contiguous_grad"]

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
        if x.shape[d] % n:
            spec[d] = None
    want = placements(spec, mesh)
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(mesh, want)


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
