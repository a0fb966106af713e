"""Entry points of the stochastic MAC array, with the JAX package's operand
signature (packed LUTs in, popcounts out):

* ``sc_mac_popcounts(..., block_k)`` — the op ``odin_linear`` calls: int32
  popcounts of trees of ``tile_k(K, block_k)`` leaves summed in int32 —
  one full MUX tree over K̂, or the hybrid regime's per-tile trees.
* ``sc_matmul_fused(..., max_tree_k)`` — the counterpart of the JAX
  ``sc_matmul_pallas``: the full tree, int32, when ``K̂ ≤ max_tree_k``;
  otherwise tiles of ``max_tree_k`` rescaled to full-tree units
  (× max_tree_k/K̂), float32.

Both run the CUDA kernel (``csrc/sc_mac.cu``) for CUDA tensors — it
launches or raises, it never falls back — and the plain PyTorch version
(``ref.py``) for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core import stochastic as sc
from repro_torch.kernels.sc_mac.ref import sc_mac_plain, tile_k
from repro_torch.kernels.sc_mac.sc_mac import sc_mac_cuda

__all__ = ["sc_mac_popcounts", "sc_matmul_fused"]


def sc_mac_popcounts(a_q, w_q, lut_a, lut_w, selects, spec: sc.StreamSpec = sc.StreamSpec(),
                     block_k: int = 0) -> torch.Tensor:
    """a_q [M, K], w_q [K, N] (uint8/int32 levels) → int32 popcounts [M, N]."""
    if a_q.is_cuda:
        if a_q.dtype != w_q.dtype or a_q.dtype not in (torch.uint8, torch.int32):
            a_q, w_q = a_q.to(torch.int32), w_q.to(torch.int32)
        return sc_mac_cuda(a_q.contiguous(), w_q.contiguous(), lut_a.contiguous(),
                           lut_w.contiguous(), selects.contiguous(),
                           block_k=tile_k(a_q.shape[-1], block_k))
    if a_q.device.type != "cpu":
        raise ValueError(f"sc_mac runs on CUDA or CPU, not {a_q.device}")
    return sc_mac_plain(a_q, w_q, lut_a, lut_w, selects, spec, block_k)


def sc_matmul_fused(a_q, w_q, lut_a, lut_w, selects, spec: sc.StreamSpec = sc.StreamSpec(),
                    *, max_tree_k: int = 2048) -> torch.Tensor:
    """The fused ODIN MAC array in the JAX wrapper's two regimes (module
    docstring)."""
    khat = 1 << sc.tree_depth(a_q.shape[-1])
    bk = tile_k(a_q.shape[-1], max_tree_k)
    pop = sc_mac_popcounts(a_q, w_q, lut_a, lut_w, selects, spec, bk)
    return pop if bk == khat else pop.to(torch.float32) * (bk / khat)
