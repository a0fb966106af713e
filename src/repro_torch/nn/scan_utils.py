"""Chunked, rematerialising time scans for recurrent blocks: the port of the
JAX package's ``nn/scan_utils.py``.

:func:`chunked_scan` is a Python loop over time in the reference's chunk
and tail order.  When autograd records it, each whole chunk runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` on its outer
scan), so the backward keeps only the chunk-boundary carries and recomputes
each chunk's steps; the tail runs as it is.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
import torch.utils.checkpoint as torch_checkpoint

from repro_torch.tree import leaves_with_path

__all__ = ["chunked_scan"]


def _run(step: Callable, carry, xs: Sequence[torch.Tensor], lo: int, hi: int):
    ys = []
    for t in range(lo, hi):
        carry, y = step(carry, [x[t] for x in xs])
        ys.append(y)
    return carry, torch.stack(ys)


def chunked_scan(step: Callable, init, xs: Sequence[torch.Tensor],
                 chunk: int = 128) -> Tuple[object, torch.Tensor]:
    """Like ``lax.scan(step, init, xs)``: ``step(carry, x_t) → (carry, y_t)``
    over the leading time axis S of every tensor in ``xs`` (a sequence of
    tensors), in ``S // chunk`` chunks of ``chunk`` steps and then the tail.
    When autograd records, each whole chunk is rematerialised in the
    backward.  Returns (final carry, ``y`` stacked over time)."""
    S = xs[0].shape[0]
    chunk = max(1, min(chunk, S))
    records = torch.is_grad_enabled() and any(
        t.requires_grad for _, _, t in leaves_with_path([init, list(xs)]))
    carry, ys = init, []
    for lo in range(0, S, chunk):           # whole chunks, then the tail
        hi = min(lo + chunk, S)
        if records and hi - lo == chunk:
            # the step draws no random numbers: no RNG state to stash
            carry, y = torch_checkpoint.checkpoint(_run, step, carry, xs, lo, hi,
                                                   use_reentrant=False,
                                                   preserve_rng_state=False)
        else:
            carry, y = _run(step, carry, xs, lo, hi)
        ys.append(y)
    return carry, ys[0] if len(ys) == 1 else torch.cat(ys)
