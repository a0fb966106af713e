"""Stochastic-rounding int8 gradient compression: the codec of the JAX
package's ``optim/compress.py``.

A gradient is cut into blocks of ``block`` elements along its trailing axis
(zero-padded), each block scaled by its max magnitude over 127 and rounded
stochastically to int8: ``floor(y) + (u < frac(y))`` with ``u`` uniform on
[0, 1), so that E[q·scale] = g.  The uniforms come from an explicit
``torch.Generator`` or are given whole (a test feeds the reference's
``jax.random`` draws).  The compressed all-reduce (``compressed_psum``)
needs collectives and belongs to the distribution slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.quant import true_div

__all__ = ["compress_int8", "decompress_int8"]


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    pad = (-x.shape[-1]) % block
    if pad:
        x = F.pad(x, (0, pad))
    return x.reshape(*x.shape[:-1], x.shape[-1] // block, block)


def compress_int8(g: torch.Tensor, generator: Optional[torch.Generator] = None,
                  block: int = 256,
                  uniforms: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """g (at least 1-D) → (int8 q of g's shape, float32 scale per block ``[..., nb]``),
    stochastic rounding.  ``uniforms`` (float32 ``[..., nb, block]``, on
    [0, 1)) are used as given; otherwise they are drawn from ``generator``."""
    orig = g.shape
    gb = _blocks(g.to(torch.float32), block)
    scale = true_div(gb.abs().amax(dim=-1), 127.0)                 # [..., nb]
    y = gb / torch.clamp_min(scale[..., None], 1e-30)
    lo = torch.floor(y)
    frac = y - lo
    if uniforms is None:
        uniforms = torch.rand(y.shape, generator=generator, dtype=torch.float32,
                              device=y.device)
    q = lo + (uniforms < frac).to(torch.float32)                   # E[q] = y
    q = torch.where(scale[..., None] > 0, q, torch.zeros_like(q))
    q = torch.clamp(q, -127, 127).to(torch.int8)
    q = q.reshape(*q.shape[:-2], -1)[..., :orig[-1]]
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor, block: int = 256) -> torch.Tensor:
    """(int8 q, per-block scale) → float32 of q's shape."""
    x = _blocks(q.to(torch.float32), block) * scale[..., None]
    return x.reshape(*x.shape[:-2], -1)[..., :q.shape[-1]]
