"""Core layers: ODIN-aware Linear, norms, embeddings, activations, RoPE.

Numerics follow the JAX package's ``nn/layers.py``: norms and RoPE upcast
to float32 and cast back to the input dtype at the same points.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.odin_linear import OdinConfig, odin_linear
from repro_torch.nn.module import ParamSpec
from repro_torch.nn.pcontext import collective_scope, is_dtensor

__all__ = [
    "linear_spec", "linear", "norm_spec", "rmsnorm", "layernorm",
    "embed_spec", "embed", "activation", "rope_freqs", "apply_rope", "apply_mrope",
]


def linear_spec(d_in: int, d_out: int, axes: Tuple[Optional[str], Optional[str]],
                dtype=torch.bfloat16, scale: float = 1.0) -> ParamSpec:
    return ParamSpec((d_in, d_out), axes, dtype, init="fan_in", scale=scale)


def linear(x: torch.Tensor, w: torch.Tensor, odin: Optional[OdinConfig] = None,
           drift_step: int = 0) -> torch.Tensor:
    """``x @ w`` routed through the configured ODIN execution mode.

    ``exact`` stays in the compute dtype; ``int8``/``sc`` run the paper's
    quantized pipeline in float32 (``core/odin_linear.py``) and cast back.
    ``drift_step`` keys the PCRAM drift-noise pattern in time; 0 keeps the
    excursion fixed per seed.
    """
    if is_dtensor(x) and x.dim() > 2:
        x = _gather_inner(x)
        with collective_scope("weights"):      # the product gathers its weight's shards
            return _InnerGatheredGrad.apply(_linear(x, w, odin, drift_step))
    return _linear(x, w, odin, drift_step)


def _linear(x, w, odin, drift_step):
    if odin is None or odin.mode == "exact":
        return torch.matmul(x, w.to(x.dtype))
    y = odin_linear(x.float(), w.float(), odin, drift_step=drift_step)
    return y.to(x.dtype)


def _gather_inner(x):
    """A DTensor activation ``[B, S, .., d]`` with its inner (sequence)
    dims gathered, batch and feature sharding kept: Megatron's sequence
    parallelism gathers the sequence before a column-parallel product, and
    the product's flattened ``[B·S, d]`` then shards as the batch alone (a
    product over a flattened batch×sequence sharding leaves DTensor to
    search redistribution plans over every candidate layout)."""
    from torch.distributed.tensor import Replicate, Shard

    inner = range(1, x.dim() - 1)
    want = [Replicate() if isinstance(p, Shard) and p.dim in inner else p
            for p in x.placements]
    return x if want == list(x.placements) else x.redistribute(x.device_mesh, want)


class _InnerGatheredGrad(torch.autograd.Function):
    """The identity on a product's DTensor output, whose backward gathers
    the gradient's inner dims as ``_gather_inner`` gathers the input's: a
    gradient arriving sequence-sharded (from the sharded activation carry)
    would otherwise reach the weight's ``[B·S, F]`` product flattened over
    batch×sequence."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _gather_inner(g)


def norm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), ("embed",), torch.float32, init="ones")


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * g).to(x.dtype)


def layernorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps) * g).to(x.dtype)


def embed_spec(vocab: int, d: int) -> ParamSpec:
    return ParamSpec((vocab, d), ("vocab", "embed"), torch.bfloat16, init="normal")


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    if is_dtensor(table):
        # DTensor has sharding strategies for the embedding op and its
        # backward (not for a gather by advanced indexing); the table is
        # gathered whole first, since a sharded lookup's masked partial sum
        # compares its mask by value, which meta shards cannot
        from torch.distributed.tensor import Replicate

        with collective_scope("weights"):
            whole = table.redistribute(table.device_mesh,
                                       [Replicate()] * table.device_mesh.ndim)
        return F.embedding(tokens.long(), whole)
    return table[tokens.long()]


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "relu2":                      # Nemotron-4 squared ReLU
        r = F.relu(x)
        return r * r
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
    return F.silu(x)                         # swiglu gate handled by caller


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    # x: [..., S, H, D]; angles: broadcastable to [..., S, 1, D/2]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    cos, sin = torch.cos(angles), torch.sin(angles)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] (int)."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)          # [D/2]
    angles = positions[..., None, None].float() * freqs              # [B, S, 1, D/2]
    return _rotate(x, angles)


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor, sections: Tuple[int, ...],
                theta: float = 10_000.0) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the ``D/2`` frequencies split into
    ``sections`` (summing to ``D/2``), section ``i`` turned by axis ``i`` of
    the (t, h, w) position ids.

    x: [B, S, H, D]; positions_3d: [B, S, 3] (int)."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)          # [D/2]
    splits = [int(s) for s in np.cumsum(sections)[:-1]]
    parts = torch.tensor_split(freqs, splits)
    angles = torch.cat([positions_3d[..., i, None].float() * parts[i]
                        for i in range(len(sections))], dim=-1)      # [B, S, D/2]
    return _rotate(x, angles[..., None, :])
