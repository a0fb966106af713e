"""8-bit quantization — the paper's "fixed 8-bit operand" adjustment (§IV-B.1).

ODIN's SN format is *unipolar* (densities in [0, 1]); signed weights are
split two-rail: a positive and a negative unipolar part, each run through
its own MAC tree and subtracted in the binary domain.  Activations after
ReLU are naturally unipolar.

The ops are the JAX package's one for one (``torch.round`` rounds half to
even, like ``jnp.round``), so the integer operands are equal bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

__all__ = ["QuantParams", "quantize_unipolar", "quantize_signed_tworail", "dequantize", "true_div"]


@dataclass(frozen=True)
class QuantParams:
    scale: torch.Tensor       # per-tensor ([]) or per-channel ([C]) float32
    n_levels: int = 256


def _amax(x: torch.Tensor, axis) -> torch.Tensor:
    m = x.abs().amax() if axis is None else x.abs().amax(dim=axis, keepdim=True)
    return torch.clamp_min(m, 1e-12)


def true_div(x: torch.Tensor, d) -> torch.Tensor:
    """``x / d`` as an IEEE division on every device.  PyTorch's CUDA kernel
    multiplies by a rounded reciprocal when the divisor is a Python number,
    which can move the quotient by an ulp (and the quantized operands with
    it); a divisor tensor on the same device is divided exactly."""
    return x / torch.full_like(x, d)


def quantize_unipolar(x: torch.Tensor, n_levels: int = 256,
                      axis=None) -> Tuple[torch.Tensor, QuantParams]:
    """Quantize non-negative ``x`` to integers in [0, n_levels-1]:
    ``x ≈ q * scale`` with ``scale = max(x)/(n_levels-1)``."""
    scale = true_div(_amax(x, axis), n_levels - 1)
    q = torch.clamp(torch.round(x / scale), 0, n_levels - 1).to(torch.uint8)
    return q, QuantParams(scale, n_levels)


def quantize_signed_tworail(w: torch.Tensor, n_levels: int = 256,
                            axis=None) -> Tuple[torch.Tensor, torch.Tensor, QuantParams]:
    """Split signed ``w`` into unipolar (pos, neg) integer rails:
    ``w ≈ (q_pos - q_neg) * scale``; at most one rail is nonzero per element."""
    scale = true_div(_amax(w, axis), n_levels - 1)
    q = torch.clamp(torch.round(w / scale), -(n_levels - 1), n_levels - 1)
    q_pos = torch.clamp_min(q, 0).to(torch.uint8)
    q_neg = torch.clamp_min(-q, 0).to(torch.uint8)
    return q_pos, q_neg, QuantParams(scale, n_levels)


def dequantize(q: torch.Tensor, params: QuantParams) -> torch.Tensor:
    return q.float() * params.scale
