"""Deterministic, stateless, step-indexed synthetic data: LM token
batches and the modality stubs' batches (MusicGen's codebooks, Qwen2-VL's
patch embeddings and M-RoPE ids), the digits — the MNIST stand-in for the
paper's CNN1/CNN2 accuracy experiments (no dataset downloads offline) — and
the Qwen2-VL vision stub's request extras.

Every batch is a pure function of ``(seed, step)``, so a run restarted from
a checkpoint replays the exact stream.  Each draws from a numpy generator
seeded by ``[seed, step, salt]`` with the JAX package's distributions (its
``jax.random`` draws themselves cannot be reproduced): ``lm_batch`` mixes
affine ramps ``(a·i + b) % V`` (``a`` in [1, 7), ``b`` in [0, V)) and
repeats of a 32-token motif with a period in [3, 17), one of the two per
row by a fair coin; the digits are 10 procedural glyph classes on a 28×28
canvas with per-sample placement jitter, amplitude and pixel noise (the
glyph bank is the JAX package's, copied verbatim).  ``pos3d`` is the JAX
package's bit for bit.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["lm_batch", "audio_stub_batch", "vlm_stub_batch", "digits_batch",
           "vlm_stub_extras"]


def lm_batch(seed: int, step: int, *, batch: int, seq: int, vocab: int,
             n_codebooks: int = 1, device="cpu") -> Dict[str, torch.Tensor]:
    """{tokens, labels} int32 ``[B, S]`` (``[B, K, S]`` with ``n_codebooks``
    K > 1: codebook ``k`` is the row's stream shifted by ``k`` mod V), the
    labels the tokens one position on."""
    rng = np.random.default_rng([seed, step, 0])
    B, S = batch, seq + 1
    i = np.arange(S)[None, :]
    a = rng.integers(1, 7, (B, 1))
    b = rng.integers(0, vocab, (B, 1))
    ramps = (a * i + b) % vocab
    period = rng.integers(3, 17, (B, 1))
    motif = rng.integers(0, vocab, (B, 32))
    motif_tokens = np.take_along_axis(motif, i % period, axis=1)
    use_ramp = rng.random((B, 1)) < 0.5
    toks = np.where(use_ramp, ramps, motif_tokens).astype(np.int32)
    if n_codebooks > 1:
        shift = np.arange(n_codebooks, dtype=np.int32)[None, :, None]
        toks = (toks[:, None, :] + shift) % vocab                    # [B, K, S]
    toks = torch.from_numpy(toks).to(device)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def audio_stub_batch(seed: int, step: int, *, batch: int, seq: int, vocab: int,
                     n_codebooks: int = 4, device="cpu") -> Dict[str, torch.Tensor]:
    """MusicGen stub: EnCodec-token batches across K codebooks ``[B, K, S]``."""
    return lm_batch(seed, step, batch=batch, seq=seq, vocab=vocab,
                    n_codebooks=n_codebooks, device=device)


def _pos3d(batch: int, seq: int, side: int) -> np.ndarray:
    """M-RoPE ids int32 ``[batch, seq, 3]``: ``side x side`` patches at (0, h, w),
    then text token ``i`` at ``i + side`` on all three axes."""
    pos = np.repeat(np.arange(seq, dtype=np.int32)[:, None] + side, 3, axis=1)
    grid = np.arange(side * side, dtype=np.int32)
    pos[:side * side] = np.stack([np.zeros_like(grid), grid // side, grid % side], axis=-1)
    return np.ascontiguousarray(np.broadcast_to(pos, (batch, seq, 3)))


def vlm_stub_batch(seed: int, step: int, *, batch: int, seq: int, vocab: int,
                   d_model: int, n_patches: int = 64, device="cpu") -> Dict[str, torch.Tensor]:
    """Qwen2-VL stub: an ``lm_batch`` with ``patch_embeds`` float32 ``[B, P,
    d_model]`` (0.02·N(0, 1)) and ``pos3d``; ``n_patches`` snaps down to a
    square grid."""
    side = max(1, int(np.sqrt(n_patches)))
    out = lm_batch(seed, step, batch=batch, seq=seq, vocab=vocab, device=device)
    rng = np.random.default_rng([seed, step, 2])
    patch = (rng.standard_normal((batch, side * side, d_model)) * 0.02).astype(np.float32)
    out["patch_embeds"] = torch.from_numpy(patch).to(device)
    out["pos3d"] = torch.from_numpy(_pos3d(batch, seq, side)).to(device)
    return out


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
    return {"patch_embeds": patch, "pos3d": _pos3d(batch, seq, side)}
