"""The benchmark's frozen traffic generator, read from a traffic file.

Prompt construction (bucketed lengths, a shared system prompt over
``share_groups``) is copied from ``repro_torch/serving/workload.py``; the
closed loop is the benchmark's own.  Nothing here imports the program.

Every seed gets the same work: lengths come in blocks that hold every
(prompt, output) pair of the buckets as often as the product of their
integer weights, each block shuffled by one fixed stream, and a client
that needs its next request takes the next pair.  The seed draws every
prompt's token ids, not the lengths or their order, so
two seeds differ in what they compute and not in how much.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

__all__ = ["ClosedLoop", "rng_for"]

# the one stream that orders the lengths, whatever the seed
_ORDER_STREAM = 20_231_107


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy stream ``stream`` of ``seed`` (any whole number)."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


class ClosedLoop:
    """Request specs of a closed-loop mix: ``next()`` → (prompt int32 [S],
    max_new)."""

    def __init__(self, spec: Dict, vocab: int, seed: int):
        self.vocab = int(vocab)
        self.rng = rng_for(seed, 1)
        self.order = np.random.default_rng(_ORDER_STREAM)
        pw = spec.get("prompt_weights") or [1] * len(spec["prompt_buckets"])
        ow = spec.get("output_weights") or [1] * len(spec["output_buckets"])
        self.block: List[Tuple[int, int]] = [
            (int(p), int(o))
            for p, a in zip(spec["prompt_buckets"], pw)
            for o, b in zip(spec["output_buckets"], ow)
            for _ in range(int(a) * int(b))]
        self.pending: List[Tuple[int, int]] = []
        shared = int(spec.get("shared_prefix", 0))
        groups = int(spec.get("share_groups", 1))
        self.systems = [self.rng.integers(0, self.vocab, size=shared, dtype=np.int32)
                        for _ in range(groups)] if shared else []
        self.count = 0

    def next(self) -> Tuple[np.ndarray, int]:
        if not self.pending:
            self.pending = [self.block[i] for i in self.order.permutation(len(self.block))]
        plen, out = self.pending.pop()
        prompt = self.rng.integers(0, self.vocab, size=plen, dtype=np.int32)
        if self.systems:
            prompt = np.concatenate([self.systems[self.count % len(self.systems)], prompt])
        self.count += 1
        return prompt, out
