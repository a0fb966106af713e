"""Training batches for one cell: the single-device subset of the JAX
package's ``launch/specs.py``.

``_batch_shapes`` gives the shape of each batch leaf and ``concrete_batch``
draws a real batch of those shapes from the step-indexed pipelines of
:mod:`repro_torch.data.synthetic`.  With gradient accumulation each leaf is
``[accum, B/accum, ...]``: microbatch ``j`` is rows ``j·B/accum ..`` of the
global batch.  The abstract specs and the sharding trees belong to the
distribution slice.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data import synthetic

__all__ = ["concrete_batch"]


def _batch_shapes(cfg: ModelConfig, shape: ShapeConfig, accum: int) -> Dict[str, Tuple]:
    """Shape tuples of the training/prefill batch for this cell."""
    B, S = shape.global_batch, shape.seq_len
    lead = (accum, B // accum) if accum > 1 else (B,)
    shapes: Dict[str, Tuple] = {}
    if cfg.n_codebooks > 1:
        shapes["tokens"] = (*lead, cfg.n_codebooks, S)
        shapes["labels"] = (*lead, cfg.n_codebooks, S)
    else:
        shapes["tokens"] = (*lead, S)
        shapes["labels"] = (*lead, S)
    if cfg.vision_stub:
        side = max(1, int(np.sqrt(min(1024, S // 4))))   # square patch grid
        shapes["patch_embeds"] = (*lead, side * side, cfg.d_model)
        shapes["pos3d"] = (*lead, S, 3)
    return shapes


def concrete_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int, step: int,
                   accum: int = 1, device="cpu") -> Dict[str, torch.Tensor]:
    """Real batch of ``_batch_shapes``' shapes on ``device``."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.vision_stub:
        out = synthetic.vlm_stub_batch(seed, step, batch=B, seq=S, vocab=cfg.vocab,
                                       d_model=cfg.d_model,
                                       n_patches=max(1, min(1024, S // 4)), device=device)
    elif cfg.n_codebooks > 1:
        out = synthetic.audio_stub_batch(seed, step, batch=B, seq=S, vocab=cfg.vocab,
                                         n_codebooks=cfg.n_codebooks, device=device)
    else:
        out = synthetic.lm_batch(seed, step, batch=B, seq=S, vocab=cfg.vocab, device=device)
    if accum > 1:
        out = {k: a.reshape(accum, a.shape[0] // accum, *a.shape[1:]) for k, a in out.items()}
    return out
