"""Stochastic-rounding int8 gradient compression: the codec of the JAX
package's ``optim/compress.py``.

A gradient is cut into blocks of ``block`` elements along its trailing axis
(zero-padded), each block scaled by its max magnitude over 127 and rounded
stochastically to int8: ``floor(y) + (u < frac(y))`` with ``u`` uniform on
[0, 1), so that E[q·scale] = g.  The uniforms come from an explicit
``torch.Generator`` or are given whole (a test feeds the reference's
``jax.random`` draws).

``compressed_psum`` is the reference's compressed all-reduce over a process
group: every rank quantizes its gradient, the per-block scales are
all-reduced by MAX, each rank re-expresses its int8 codes on that shared
scale (``round``, half to even), the codes are all-reduced by SUM as int32
and multiplied back.  The wire payload is the int32-widened code (4 bytes an
element, as the reference's ``psum`` of ``int32``), plus the float32 scales.
``compressed_psum_plain`` computes the same over a list of every rank's
gradient in one process: the yardstick of the tests and of the card's check.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.quant import true_div

__all__ = ["compress_int8", "decompress_int8", "compressed_psum", "compressed_psum_plain",
           "draw_uniforms"]


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


def _rescaled_codes(q: torch.Tensor, scale: torch.Tensor, s_max: torch.Tensor,
                    block: int) -> torch.Tensor:
    """One rank's int8 codes re-expressed on the shared block scale
    ``s_max`` (codes of a block whose shared scale is 0 are 0), as int32."""
    ratio = torch.where(s_max > 0, scale / torch.clamp_min(s_max, 1e-30),
                        torch.zeros_like(scale))
    return torch.round(_blocks(q.to(torch.float32), block) * ratio[..., None]).to(torch.int32)


def _expand(q_sum: torch.Tensor, s_max: torch.Tensor, n: int) -> torch.Tensor:
    x = q_sum.to(torch.float32) * s_max[..., None]
    return x.reshape(*x.shape[:-2], -1)[..., :n]


# Blocks of one piece of ``compressed_psum``: its float32 temporaries are a
# few copies of a piece (64 MiB each), not of a whole leaf (a 200,064 x 3072
# embedding's are 2.5 GB each, and two ranks share one card).
PIECE_BLOCKS = 1 << 16


def draw_uniforms(shape, generator: torch.Generator, device, block: int = 256) -> torch.Tensor:
    """The uniforms ``compressed_psum`` draws from ``generator`` for a
    gradient of ``shape``: ``[..., nb, block]``, drawn a piece of
    ``PIECE_BLOCKS`` blocks at a time, in order."""
    lead, nb = tuple(shape[:-1]), -(-shape[-1] // block)
    return torch.cat([torch.rand((*lead, min(PIECE_BLOCKS, nb - b0), block),
                                 generator=generator, dtype=torch.float32, device=device)
                      for b0 in range(0, nb, PIECE_BLOCKS)], dim=-2)


def compressed_psum(g: torch.Tensor, group=None, generator: Optional[torch.Generator] = None,
                    block: int = 256, uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The sum of ``g`` over the ranks of ``group`` (None: the default
    group) with an int8-compressed payload: float32 of ``g``'s shape on
    every rank.  ``uniforms`` (``[..., nb, block]``) are ``compress_int8``'s;
    without them each piece draws its own from ``generator`` (the draws of
    ``draw_uniforms``).  The reference feeds every rank the same draws.
    The trailing axis goes a piece of ``PIECE_BLOCKS`` blocks at a time,
    each with its own two all-reduces: every block is independent, so the
    result is the one of the whole."""
    import torch.distributed as dist

    n, out = g.shape[-1], []
    for b0 in range(0, -(-n // block), PIECE_BLOCKS):
        piece = g[..., b0 * block:(b0 + PIECE_BLOCKS) * block]
        u = None if uniforms is None else uniforms[..., b0:b0 + PIECE_BLOCKS, :]
        q, scale = compress_int8(piece, generator, block, u)
        s_max = scale.clone()
        dist.all_reduce(s_max, op=dist.ReduceOp.MAX, group=group)
        q_sum = _rescaled_codes(q, scale, s_max, block)
        del q
        dist.all_reduce(q_sum, op=dist.ReduceOp.SUM, group=group)
        out.append(_expand(q_sum, s_max, piece.shape[-1]))
    return out[0] if len(out) == 1 else torch.cat(out, dim=-1)


def compressed_psum_plain(gs, uniforms, block: int = 256) -> torch.Tensor:
    """``compressed_psum`` of the ranks' gradients ``gs`` (a list, rank
    order) in one process, rank ``r`` quantizing with ``uniforms[r]`` (one
    tensor shared by every rank is also accepted)."""
    if isinstance(uniforms, torch.Tensor):
        uniforms = [uniforms] * len(gs)
    coded = [compress_int8(g, None, block, u) for g, u in zip(gs, uniforms)]
    s_max = coded[0][1]
    for _, s in coded[1:]:
        s_max = torch.maximum(s_max, s)
    q_sum = sum(_rescaled_codes(q, s, s_max, block) for q, s in coded)
    return _expand(q_sum, s_max, gs[0].shape[-1])
