"""Abstract inputs, real batches and sharding trees per (arch × shape) cell,
the port of the JAX package's ``launch/specs.py``.

``input_specs`` gives meta-device stand-ins (shape and dtype, no memory) for
every model input of a cell, so the dry-run traces full-size cells on any
host; ``concrete_batch`` draws a real batch of the same shapes from the
step-indexed pipelines of :mod:`repro_torch.data.synthetic`.  With gradient
accumulation each leaf is ``[accum, B/accum, ...]``: microbatch ``j`` is
rows ``j·B/accum ..`` of the global batch.

Sharding trees: batch-bearing leaves shard their leading batch axis over the
data(+pod) mesh axes; decode caches shard sequence over ``model``
(flash-decode) and batch over data.  Any axis that does not divide its mesh
axes is left unsharded (the ``long_500k`` B=1 cell).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import LM_SHAPES, ModelConfig, ShapeConfig
from repro_torch.data import synthetic
from repro_torch.models import lm, registry
from repro_torch.nn.module import P, axis_sizes, placements
from repro_torch.nn.pcontext import from_block
from repro_torch.tree import map_with_name, tree_map

__all__ = [
    "input_specs",
    "concrete_batch",
    "batch_pspecs",
    "cache_pspecs",
    "abstract_caches",
    "sharded_caches",
    "DRYRUN_ACCUM",
    "DRYRUN_ACCUM_DTYPE",
]

# Gradient-accumulation factor per arch for the train_4k cell, the
# reference's: it keeps the saved layer-boundary activations within a chip's
# budget; the MoE giants run accum=1 (a float32 gradient buffer alone would
# not fit) and dense 405B accum=4.
DRYRUN_ACCUM = {
    "deepseek-v3-671b": 1,
    "qwen3-moe-235b-a22b": 1,
    "llama3-405b": 4,
    "nemotron-4-15b": 4,
    "phi3-medium-14b": 4,
    "phi4-mini-3.8b": 2,
    "qwen2-vl-2b": 1,
    "hymba-1.5b": 1,
    "musicgen-medium": 1,
    "xlstm-350m": 1,
}

# Accumulation dtype per arch (the reference's): bf16 halves the per-layer
# dW reduce payload and the carry of the 405B cell.
DRYRUN_ACCUM_DTYPE = {
    "llama3-405b": "bfloat16",
}


def _fsdp_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    axes = (axes,) if isinstance(axes, str) else axes
    sizes = axis_sizes(mesh)
    return int(np.prod([sizes[a] for a in axes]))


def _maybe(mesh, dim: int, axes):
    """Shard ``dim`` over ``axes`` only when divisible (else replicate)."""
    return axes if dim % max(1, _axis_size(mesh, axes)) == 0 else None


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


def _batch_dtype(name: str) -> torch.dtype:
    return torch.float32 if name == "patch_embeds" else torch.int32


def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh, accum: int) -> Dict[str, P]:
    fsdp = _fsdp_axes(mesh)
    out = {}
    for name, shp in _batch_shapes(cfg, shape, accum).items():
        batch_dim = shp[1] if accum > 1 else shp[0]
        ax = _maybe(mesh, batch_dim, fsdp)
        if accum > 1:
            out[name] = P(None, ax, *([None] * (len(shp) - 2)))
        else:
            out[name] = P(ax, *([None] * (len(shp) - 1)))
    return out


def _train_specs(cfg: ModelConfig, shape: ShapeConfig, accum: int, device="meta"):
    return {name: torch.empty(shp, dtype=_batch_dtype(name), device=device)
            for name, shp in _batch_shapes(cfg, shape, accum).items()}


def abstract_caches(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                    device="meta"):
    """The stacked decode caches of ``lm.init_caches`` on the meta device
    (shapes and dtypes, no memory)."""
    return lm.init_caches(cfg, batch, max_len, dtype, device=device)


def cache_pspecs(cfg: ModelConfig, caches_tpl, mesh):
    """Partition spec tree for the stacked caches.

    Leading axis is always ``layers`` (unsharded); batch shards on
    data(+pod); the long sequence axis of KV/latent caches shards on
    ``model`` (flash-decode); head/state minor axes stay local.
    """
    fsdp = _fsdp_axes(mesh)

    def leaf_spec(name, leaf):
        shp = leaf.shape
        if name == "pos":
            return P(*([None] * len(shp)))
        b_ax = _maybe(mesh, shp[1], fsdp) if len(shp) >= 2 else None
        if name in ("k", "v"):              # [L, B, S, Hkv, D]
            return P(None, b_ax, _maybe(mesh, shp[2], "model"), None, None)
        if name in ("c_kv", "k_rope"):      # [L, B, S, r]
            return P(None, b_ax, _maybe(mesh, shp[2], "model"), None)
        if name == "h" and len(shp) == 4:    # SSM state [L, B, d_inner, N]
            return P(None, b_ax, _maybe(mesh, shp[2], "model"), None)
        if name == "h" and len(shp) == 3:    # sLSTM hidden [L, B, d]
            return P(None, b_ax, _maybe(mesh, shp[2], "model"))
        if name == "conv":                   # [L, B, K-1, d_inner]
            return P(None, b_ax, None, _maybe(mesh, shp[3], "model"))
        if name == "C":                      # [L, B, H, dk, dv]
            return P(None, b_ax, _maybe(mesh, shp[2], "model"), None, None)
        if name in ("n", "m", "c"):
            rest = [None] * (len(shp) - 2)
            if len(shp) >= 3:
                rest[0] = _maybe(mesh, shp[2], "model")
            return P(None, b_ax, *rest)
        return P(*([None] * len(shp)))

    return map_with_name(leaf_spec, caches_tpl)


def sharded_caches(cfg: ModelConfig, batch: int, max_len: int, mesh, device, dtype=None):
    """The fresh caches of ``lm.init_caches`` as DTensors placed by
    ``cache_pspecs`` on ``mesh`` (the reference's prefill ``out_shardings``):
    each rank allocates only its own shards, on ``device``, filled with
    each leaf's initial value."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    tpl = lm.init_caches(cfg, batch, max_len, dtype, device="meta")
    # every leaf starts as one value (zeros, mLSTM's -1e30, sLSTM's 1.0)
    first = lm.init_caches(cfg, 1, 1, dtype, device="cpu")

    def one(t, spec, v):
        pl = placements(spec, mesh)
        local, _ = compute_local_shape_and_global_offset(t.shape, mesh, pl)
        block = torch.full(local, v.reshape(-1)[0].item(), dtype=t.dtype, device=device)
        return from_block(block, mesh, pl, t.shape)

    return tree_map(one, tpl, cache_pspecs(cfg, tpl, mesh), first)


def input_specs(arch: str, shape_name: str, *, smoke: bool = False,
                accum: Optional[int] = None, kv_dtype: Optional[str] = None) -> Dict:
    """Abstract inputs for one (arch × shape) cell.

    Returns a dict with ``kind`` plus the meta tensors the matching step
    runs on:
      train   → {batch}
      prefill → {batch}  (forward-only, fresh caches built inside the step)
      decode  → {tokens, caches}
    """
    cfg = registry.get_smoke(arch) if smoke else registry.get_config(arch)
    if kv_dtype is not None:
        cfg = cfg.with_overrides(kv_dtype=kv_dtype)
    shape = LM_SHAPES[shape_name]
    if smoke:
        shape = ShapeConfig(shape.name, min(shape.seq_len, 64), min(shape.global_batch, 4),
                            shape.kind)
    acc = accum if accum is not None else (
        DRYRUN_ACCUM.get(arch, 1) if shape.kind == "train" and not smoke else 1)

    if shape.kind == "train":
        return {"kind": "train", "cfg": cfg, "shape": shape, "accum": acc,
                "batch": _train_specs(cfg, shape, acc)}
    if shape.kind == "prefill":
        return {"kind": "prefill", "cfg": cfg, "shape": shape, "accum": 1,
                "batch": _train_specs(cfg, shape, 1)}
    # decode: one new token against a seq_len-deep cache
    B, S = shape.global_batch, shape.seq_len
    tok_shape = (B, cfg.n_codebooks, 1) if cfg.n_codebooks > 1 else (B, 1)
    return {
        "kind": "decode", "cfg": cfg, "shape": shape, "accum": 1,
        "tokens": torch.empty(tok_shape, dtype=torch.int32, device="meta"),
        "caches": abstract_caches(cfg, B, S),
    }


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
