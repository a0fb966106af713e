"""Deterministic synthetic data: step-indexed digits — the MNIST stand-in
for the paper's CNN1/CNN2 accuracy experiments (no dataset downloads
offline) — and the Qwen2-VL vision stub's request extras.

``digits_batch(seed, step, batch=B)`` is a pure function of ``(seed, step)``:
10 procedural glyph classes on a 28×28 canvas with per-sample placement
jitter, amplitude and pixel noise, drawn from a numpy generator seeded by
``(seed, step)`` with the JAX package's distributions (its ``jax.random``
draws themselves cannot be reproduced).  The glyph bank is the JAX
package's, copied verbatim.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["digits_batch", "vlm_stub_extras"]


def _glyph_bank() -> np.ndarray:
    """10 class templates, 20×20, drawn with numpy strokes (deterministic)."""
    g = np.zeros((10, 20, 20), np.float32)
    y, x = np.mgrid[0:20, 0:20]

    def ring(cy, cx, r0, r1):
        d = np.sqrt((y - cy) ** 2 + (x - cx) ** 2)
        return ((d >= r0) & (d <= r1)).astype(np.float32)

    g[0] = ring(10, 10, 5, 8)
    g[1][:, 9:12] = 1.0
    g[2] = ring(6, 10, 3, 6) * (y <= 8) ; g[2][8:18][np.eye(10, 20, 8, dtype=bool)[:, ::-1]] = 1; g[2][16:19, 4:16] = 1
    g[3] = ring(5, 10, 3, 6) * (x >= 9) + ring(13, 10, 3, 6) * (x >= 9)
    g[4][:12, 4:7] = 1; g[4][9:12, 4:16] = 1; g[4][:, 12:15] = 1
    g[5][2:5, 4:16] = 1; g[5][2:10, 4:7] = 1; g[5][8:11, 4:14] = 1; g[5] += ring(13, 9, 3, 6) * (x >= 7)
    g[6] = ring(13, 10, 3, 6); g[6][2:13, 6:9] = 1
    g[7][2:5, 4:16] = 1; g[7] += ((np.abs((19 - y) * 0.6 + 4 - (x - 8)) < 1.6) & (y >= 4)).astype(np.float32)
    g[8] = ring(6, 10, 2.5, 5) + ring(14, 10, 2.5, 5.5)
    g[9] = ring(6, 10, 3, 6); g[9][6:18, 13:16] = 1
    return np.clip(g, 0, 1)


_GLYPHS = _glyph_bank()


def digits_batch(seed: int, step: int, *, batch: int, device="cpu") -> Dict[str, torch.Tensor]:
    """{image float32 [B,28,28,1] in [0,1], label int64 [B]} on ``device``."""
    rng = np.random.default_rng([seed, step, 1])
    B = batch
    labels = rng.integers(0, 10, B)
    dx = rng.integers(0, 9, B)                      # placement on 28×28
    dy = rng.integers(0, 9, B)
    amp = rng.uniform(0.7, 1.0, (B, 1, 1))
    noise = rng.uniform(0.0, 0.15, (B, 28, 28))

    canvas = np.zeros((B, 28, 28))
    glyphs = _GLYPHS[labels] * amp                  # [B, 20, 20]
    for b in range(B):
        canvas[b, dy[b]:dy[b] + 20, dx[b]:dx[b] + 20] = glyphs[b]
    img = np.clip(canvas + noise, 0.0, 1.0).astype(np.float32)
    return {"image": torch.from_numpy(img[..., None]).to(device),
            "label": torch.from_numpy(labels).to(device)}


def vlm_stub_extras(seed: int, *, batch: int, seq: int, d_model: int,
                    n_patches: int = 64) -> Dict[str, np.ndarray]:
    """The Qwen2-VL stub's extras as numpy arrays: ``patch_embeds`` float32
    ``[batch, P, d_model]`` (0.02·N(0, 1) from a numpy generator seeded by
    ``seed``; the JAX package's ``jax.random`` draws cannot be reproduced)
    and ``pos3d`` int32 ``[batch, seq, 3]``, the JAX package's M-RoPE ids
    exactly: ``n_patches`` snaps down to a square ``side x side`` grid of
    patches at (0, h, w), and text token ``i`` sits at ``i + side`` on all
    three axes."""
    side = max(1, int(np.sqrt(n_patches)))
    n_patches = side * side
    rng = np.random.default_rng([seed, 2])
    patch = (rng.standard_normal((batch, n_patches, d_model)) * 0.02).astype(np.float32)
    pos = np.repeat(np.arange(seq, dtype=np.int32)[:, None] + side, 3, axis=1)
    grid = np.arange(n_patches, dtype=np.int32)
    pos[:n_patches] = np.stack([np.zeros_like(grid), grid // side, grid % side], axis=-1)
    return {"patch_embeds": patch,
            "pos3d": np.ascontiguousarray(np.broadcast_to(pos, (batch, seq, 3)))}
