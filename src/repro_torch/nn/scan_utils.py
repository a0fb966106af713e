"""Time scans for recurrent blocks: the port of the JAX package's
``nn/scan_utils.py``.

The JAX package nests two ``lax.scan``s and checkpoints the inner one, so
that training saves only chunk-boundary carries.  The port runs inference
only, so :func:`chunked_scan` is a plain Python loop over time with the
same chunk and tail order; it stays a function of its own, so that a
training port can put a checkpoint on each chunk.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

__all__ = ["chunked_scan"]


def chunked_scan(step: Callable, init, xs: Sequence[torch.Tensor],
                 chunk: int = 128) -> Tuple[object, torch.Tensor]:
    """Like ``lax.scan(step, init, xs)``: ``step(carry, x_t) → (carry, y_t)``
    over the leading time axis S of every tensor in ``xs`` (a sequence of
    tensors), in ``S // chunk`` chunks of ``chunk`` steps and then the tail.
    Returns (final carry, ``y`` stacked over time)."""
    S = xs[0].shape[0]
    chunk = max(1, min(chunk, S))
    carry, ys = init, []
    for lo in range(0, S, chunk):           # whole chunks, then the tail
        for t in range(lo, min(lo + chunk, S)):
            carry, y = step(carry, [x[t] for x in xs])
            ys.append(y)
    return carry, torch.stack(ys)
