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
picks the plain version it needs.  ``sc_mac_split_ref`` is the CUDA
kernel's algorithm in plain PyTorch, for the tests: the tree as an OR of
leaves under disjoint masks (``leaf_masks``), K cut into splits of 32-leaf
chunks, popcounts summed within and across splits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import stochastic as sc
from repro_torch.kernels.sc_mac.sc_mac import CHUNK

__all__ = ["sc_matmul_tree_ref", "sc_matmul_hybrid_ref", "sc_mac_plain", "ranks_from_lut",
           "tile_k", "leaf_masks", "sc_mac_split_ref"]

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


def leaf_masks(selects: torch.Tensor, bk: int) -> torch.Tensor:
    """A MUX tree of ``bk`` leaves as masks: int32 ``[bk, W]``, row p the
    bits the root takes from leaf p.  Level l passes the even child where
    its select bit is 1, so leaf p owns the bits where ``sel_l`` is
    ``1 - bit_l(p)`` at every level; the rows are disjoint and cover every
    bit, and the root is the OR over p of ``mask_p & leaf_p``."""
    p = torch.arange(bk, device=selects.device)
    m = torch.full((bk, selects.shape[-1]), -1, dtype=torch.int32, device=selects.device)
    for level in range(bk.bit_length() - 1):
        odd = ((p >> level) & 1).bool()[:, None]
        m &= torch.where(odd, ~selects[level][None], selects[level][None])
    return m


def sc_mac_split_ref(a_q, w_q, lut_a, lut_w, selects, block_k: int, *, chunks_per_split: int,
                     group: int, swap: bool = False) -> torch.Tensor:
    """The CUDA kernel's algorithm (``csrc/sc_mac.cu``) → int32 [M, N]: the
    streams of one operand (a's, or w's when ``swap``) masked with
    ``leaf_masks`` of their leaf's position in its tree of
    ``tile_k(K, block_k)`` leaves; K cut into the kernel's chunks of
    ``CHUNK`` leaves and the chunks into splits of ``chunks_per_split``; in
    a chunk, the products
    OR-ed over each ``group`` of leaves and popcounted; the popcounts summed
    within a split, then across splits."""
    M, K = a_q.shape
    N = w_q.shape[1]
    bk = tile_k(K, block_k)
    if CHUNK % group or bk % group:
        raise ValueError(f"group {group} must divide the chunk {CHUNK} and the tree {bk}")
    kmask = leaf_masks(selects, bk)[torch.arange(K, device=a_q.device) % bk]   # [K, W]
    sa = sc.b_to_s(a_q, lut_a)                                  # [M, K, W]
    sw = sc.b_to_s(w_q, lut_w).permute(1, 0, 2)                 # [N, K, W]
    if swap:
        sw = sw & kmask[None]
    else:
        sa = sa & kmask[None]
    n_chunks = -(-K // CHUNK)
    pad = n_chunks * CHUNK - K
    sa = torch.nn.functional.pad(sa, (0, 0, 0, pad))
    sw = torch.nn.functional.pad(sw, (0, 0, 0, pad))
    out = torch.zeros((M, N), dtype=torch.int32, device=a_q.device)
    for c0 in range(0, n_chunks, chunks_per_split):
        part = torch.zeros_like(out)
        for c in range(c0, min(c0 + chunks_per_split, n_chunks)):
            k0 = c * CHUNK
            prod = sa[:, None, k0:k0 + CHUNK] & sw[None, :, k0:k0 + CHUNK]   # [M, N, CHUNK, W]
            prod = prod.reshape(M, N, CHUNK // group, group, -1)
            acc = prod[:, :, :, 0]
            for j in range(1, group):
                acc = acc | prod[:, :, :, j]
            part += sc.popcount32(acc).sum(dim=(-1, -2)).to(torch.int32)
        out += part
    return out
