"""Weights carried across from the JAX package.

``params_from_numpy(tree, device)`` takes the JAX package's param tree with
numpy leaves — ``jax.tree.map(np.asarray, params)`` of a materialised tree,
or the arrays of a ``checkpoint/ckpt.py`` ``arrays.npz`` put back into the
tree — and returns the port's tree: the same dict/list structure and keys,
the same stacked ``[L, ...]`` segment leaves, as tensors on ``device``.

Every leaf keeps the dtype the JAX spec gave it: bf16 weights stay bf16,
and the float32 leaves (norms, MLA's ``kv_norm`` and ``q_norm``, the MoE
router and DeepSeek's ``route_bias``, the SSM's ``A_log``, ``D`` and
``dt_bias``, Hymba's ``mix_beta``, the sLSTM's ``r_zifo``) stay float32,
unless ``dtype`` casts every floating leaf.  DeepSeek's ``mtp`` subtree crosses like the rest.
numpy's bfloat16 leaves are ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` rejects: they cross as their uint16 bit patterns
and are viewed back as ``torch.bfloat16``, bit for bit (the same trick
``ckpt.py`` uses to store them).

``luts_from_numpy(lut_a, lut_w, selects, device)`` carries the JAX package's
SC tables (``core/odin_linear.py get_luts``, uint32 words) across as the
int32 tensors with the same bit patterns, which is how the port holds
stream words.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map

__all__ = ["params_from_numpy", "luts_from_numpy"]


def _leaf(a, device, dtype):
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:                # torch tensors must own writable memory
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device, dtype=None):
    """numpy-leaf param tree → tensor tree on ``device``.  ``dtype`` (e.g.
    ``torch.float32``) casts every floating leaf; integer leaves keep theirs."""
    return tree_map(lambda a: _leaf(a, device, dtype), tree)


def luts_from_numpy(lut_a, lut_w, selects, device="cpu"):
    """The JAX ``(lut_a, lut_w, selects)`` uint32 tables → the port's int32
    tables on ``device``, bit for bit."""
    def words(a):
        a = np.ascontiguousarray(np.asarray(a))
        if a.dtype != np.uint32:
            raise ValueError(f"SC tables are uint32 words, got {a.dtype}")
        return torch.from_numpy(a.view(np.int32).copy()).to(device)

    return words(lut_a), words(lut_w), words(selects)
