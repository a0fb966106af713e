"""Plain PyTorch versions of the sc_mac kernel, one for each regime:

* ``sc_matmul_tree_ref``   — one full MUX tree over K̂.  Bit-identical to
  ``core.stochastic.sc_matmul`` by an independent derivation (streams from
  the comparator SNG over the ranks recovered from the LUT).
* ``sc_matmul_hybrid_ref`` — K tiled into ``block_k`` chunks; each chunk is
  reduced by its own depth-log2(block_k) MUX tree and popcounted; chunk
  popcounts accumulate in int32 (the kernel's binary accumulate).

Both walk the rows of ``a`` in chunks so the ``[m, N, bk, W]`` product
streams stay near ``_CHUNK_ELEMS`` elements; chunking changes no bit.
``tile_k`` is the one place that decides the regime, and ``sc_mac_plain``
picks the plain version it needs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import stochastic as sc

__all__ = ["sc_matmul_tree_ref", "sc_matmul_hybrid_ref", "sc_mac_plain", "ranks_from_lut",
           "tile_k"]

_CHUNK_ELEMS = 1 << 25


def tile_k(K: int, block_k: int) -> int:
    """Leaves of one MUX tree for a reduction of length ``K``: ``block_k``
    (the hybrid regime), or K̂ = 2^tree_depth(K) — one full tree — when
    ``block_k`` is 0 or at least K̂."""
    khat = 1 << sc.tree_depth(K)
    return block_k if 0 < block_k < khat else khat


def ranks_from_lut(lut: torch.Tensor, n_levels: int) -> torch.Tensor:
    """Recover the SNG permutation ranks from a packed LUT.

    Bit ``i`` is set in rows ``v > rank_i``, so its column popcount over the
    rows is ``(L-1) - min(rank_i, L-1)``.  Ranks ≥ L-1 act like L-1 in every
    comparison with v < L, so the capped recovery is exact for stream
    generation.  Returned as int32 ``[W, 32]`` (word, bit) layout.
    """
    counts = sc.unpack_bits(lut).sum(dim=0).to(torch.int32)   # [stream_len]
    return ((n_levels - 1) - counts).reshape(lut.shape[-1], 32)


def _stream_table(ranks_w32: torch.Tensor, n_levels: int) -> torch.Tensor:
    """Comparator SNG for every level: int32 [n_levels, W] with row v =
    pack_j(v > ranks[w, j]) — the streams the kernel's LUT rows hold."""
    v = torch.arange(n_levels, device=ranks_w32.device)[:, None, None]
    return sc.pack_bits((v > ranks_w32[None]).reshape(n_levels, -1))


def _products(a_t, w_t, table_a, table_w):
    """AND of the streams of a [m, bk] and w [bk, N] → [m, N, bk, W]."""
    sa = sc.b_to_s(a_t, table_a)                              # [m, bk, W]
    sw = sc.b_to_s(w_t, table_w).permute(1, 0, 2)             # [N, bk, W]
    return sa[:, None] & sw[None]


def _chunk_rows(N: int, bk: int, W: int) -> int:
    return max(1, _CHUNK_ELEMS // max(1, N * bk * W))


def sc_matmul_tree_ref(a_q, w_q, lut_a, lut_w, selects, spec: sc.StreamSpec):
    """Full-tree version (== core.stochastic.sc_matmul) → int32 [M, N]."""
    M, K = a_q.shape
    N = w_q.shape[1]
    ta = _stream_table(ranks_from_lut(lut_a, spec.n_levels), spec.n_levels)
    tw = _stream_table(ranks_from_lut(lut_w, spec.n_levels), spec.n_levels)
    out = torch.empty((M, N), dtype=torch.int32, device=a_q.device)
    step = _chunk_rows(N, 1 << sc.tree_depth(K), spec.n_words)
    for r in range(0, M, step):
        prod = _products(a_q[r:r + step], w_q, ta, tw)
        out[r:r + step] = sc.s_to_b(sc.sc_mac_tree(prod, selects))
    return out


def sc_matmul_hybrid_ref(a_q, w_q, lut_a, lut_w, selects, spec: sc.StreamSpec,
                         block_k: int):
    """Tiled-hybrid version: per-K-tile MUX subtree + int32 popcount
    accumulate → int32 [M, N]."""
    M, K = a_q.shape
    N = w_q.shape[1]
    depth = int(np.log2(block_k))
    if 1 << depth != block_k:
        raise ValueError(f"block_k must be a power of two, got {block_k}")
    pad = (-K) % block_k
    a_p = torch.nn.functional.pad(a_q.to(torch.int32), (0, pad))
    w_p = torch.nn.functional.pad(w_q.to(torch.int32), (0, 0, 0, pad))
    ta = _stream_table(ranks_from_lut(lut_a, spec.n_levels), spec.n_levels)
    tw = _stream_table(ranks_from_lut(lut_w, spec.n_levels), spec.n_levels)
    out = torch.zeros((M, N), dtype=torch.int32, device=a_q.device)
    step = _chunk_rows(N, block_k, spec.n_words)
    for t in range(0, K + pad, block_k):
        w_t = w_p[t:t + block_k]
        for r in range(0, M, step):
            x = _products(a_p[r:r + step, t:t + block_k], w_t, ta, tw)
            for level in range(depth):
                sel = selects[level]
                x = (sel & x[..., 0::2, :]) | (~sel & x[..., 1::2, :])
            out[r:r + step] += sc.s_to_b(x[..., 0, :])
    return out


def sc_mac_plain(a_q, w_q, lut_a, lut_w, selects, spec: sc.StreamSpec, block_k: int):
    """The plain version of the kernel for trees of ``tile_k(K, block_k)``
    leaves → int32 [M, N]."""
    bk = tile_k(a_q.shape[-1], block_k)
    if bk == 1 << sc.tree_depth(a_q.shape[-1]):
        return sc_matmul_tree_ref(a_q, w_q, lut_a, lut_w, selects, spec)
    return sc_matmul_hybrid_ref(a_q, w_q, lut_a, lut_w, selects, spec, bk)
