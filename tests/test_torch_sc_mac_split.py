"""The CUDA stochastic-MAC kernel's algorithm, run in plain PyTorch by
``sc_mac_split_ref``: the MUX tree as an OR of leaves under disjoint masks,
K cut into splits of 32-leaf chunks, popcounts summed within and across
splits.  Held bit for bit against the plain version ``sc_mac_plain`` in
both regimes, uint8 and int32, ragged K, at split counts from one to one a
chunk, and on two shapes against the JAX package's Pallas kernel in
interpret mode.  Also the host-side plan: it covers every chunk once,
lands hybrid splits on tree boundaries and reads nothing but shapes."""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import stochastic as jsc
from repro.core.odin_linear import get_luts as jax_get_luts
from repro.kernels.sc_mac import sc_matmul_pallas
from repro_torch.bridge import luts_from_numpy
from repro_torch.core import stochastic as sc
from repro_torch.kernels.sc_mac import (leaf_masks, sc_mac_plain, sc_mac_split_ref, sc_plan,
                                        tile_k)
from repro_torch.kernels.sc_mac.sc_mac import _MAX_SMEM, smem_bytes

SPEC = sc.StreamSpec(256, 256)
JSPEC = jsc.StreamSpec(256, 256)
JLUTS = jax_get_luts(256, 256, 0)
LUTS = luts_from_numpy(*JLUTS)
H100_SMS = 132


def _operands(seed, M, K, N, dtype, levels=256):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.integers(0, levels, (M, K)).astype(dtype)),
            torch.as_tensor(rng.integers(0, levels, (K, N)).astype(dtype)))


def _split(a, w, block_k, chunks_per_split, luts=LUTS, spec=SPEC):
    M, K = a.shape
    bk = tile_k(K, block_k)
    plan = sc_plan(M, w.shape[1], K, bk, spec.n_words, H100_SMS)
    return sc_mac_split_ref(a, w, *luts, block_k, chunks_per_split=chunks_per_split,
                            group=plan["group"], swap=plan["swap"])


# M, K, N: ragged K throughout; M > N takes the swapped roles (w's streams masked)
SHAPES = [(2, 100, 5), (3, 77, 2), (1, 33, 1)]


@pytest.mark.parametrize("chunks_per_split", [1, 2, 4])
@pytest.mark.parametrize("block_k", [0, 2, 8, 32, 64])
@pytest.mark.parametrize("M,K,N", SHAPES)
@pytest.mark.parametrize("dtype", ["uint8", "int32"])
def test_split_matches_plain(M, K, N, block_k, chunks_per_split, dtype):
    """One split (4 ≥ every shape's chunks), one a chunk and two a chunk:
    the hybrid trees of 2..32 leaves, trees of 64 cut mid-tree, and the
    full tree of K̂ = 128 cut into chunks."""
    a, w = _operands(M * 1000 + K * 10 + N + block_k, M, K, N, dtype)
    want = sc_mac_plain(a, w, *LUTS, SPEC, block_k)
    assert torch.equal(_split(a, w, block_k, chunks_per_split), want)


@pytest.mark.parametrize("block_k", [0, 32])
def test_one_split_per_tree_and_full_tree_past_2048(block_k):
    """K = 2100: 66 trees of 32 (one split each, a split per tree), or one
    full tree of 4096 leaves cut into 66 splits of one chunk."""
    a, w = _operands(5, 2, 2100, 3, "uint8")
    want = sc_mac_plain(a, w, *LUTS, SPEC, block_k)
    assert torch.equal(_split(a, w, block_k, 1), want)


def test_split_with_levels_past_the_table_and_int32_clamp():
    """int32 operands below 0 and past L-1 clamp in the split algorithm as
    in the plain version."""
    rng = np.random.default_rng(3)
    a = torch.as_tensor(rng.integers(-40, 300, (3, 70)).astype("int32"))
    w = torch.as_tensor(rng.integers(-40, 300, (70, 4)).astype("int32"))
    for block_k in (0, 8, 32):
        assert torch.equal(_split(a, w, block_k, 1), sc_mac_plain(a, w, *LUTS, SPEC, block_k))


def test_split_nondefault_stream_geometry():
    spec = sc.StreamSpec(128, 128)
    luts = luts_from_numpy(*jax_get_luts(128, 128, 3))
    a, w = _operands(9, 4, 50, 3, "int32", levels=128)
    for block_k in (0, 8):
        assert torch.equal(_split(a, w, block_k, 1, luts, spec),
                           sc_mac_plain(a, w, *luts, spec, block_k))


@pytest.mark.parametrize("M,K,N,max_tree_k", [(3, 70, 5, 0), (2, 90, 4, 32)])
def test_split_matches_jax_kernel(M, K, N, max_tree_k):
    """The full tree (one tree of 128 leaves) and the hybrid regime (trees
    of 32) against the Pallas kernel in interpret mode."""
    a, w = _operands(M + K + N, M, K, N, "int32")
    kw = dict(max_tree_k=max_tree_k) if max_tree_k else {}
    theirs = np.asarray(sc_matmul_pallas(jnp.asarray(a.numpy()), jnp.asarray(w.numpy()),
                                         *JLUTS, JSPEC, interpret=True, **kw))
    pops = _split(a, w, max_tree_k, 1)
    if max_tree_k:      # the JAX wrapper rescales tiles to full-tree units
        khat = 1 << sc.tree_depth(K)
        np.testing.assert_array_equal((pops.float() * (max_tree_k / khat)).numpy(), theirs)
    else:
        np.testing.assert_array_equal(pops.numpy(), theirs)


@pytest.mark.parametrize("bk", [2, 8, 32, 256])
def test_leaf_masks_partition_every_bit(bk):
    """A tree's leaf masks are disjoint and cover all of a stream."""
    m = leaf_masks(LUTS[2], bk)
    assert int(sc.popcount32(m).sum()) == SPEC.stream_len
    acc = torch.zeros_like(m[0])
    for row in m:
        assert not torch.any(acc & row)
        acc |= row
    assert torch.all(acc == -1)


PLAN_SHAPES = [  # decode and prefill rows of phi4's projections, the CNN path, odd shapes
    (2, 3072, 8192, 32), (2, 3072, 1024, 32), (2, 8192, 3072, 32), (8, 3072, 8192, 32),
    (32, 3072, 3072, 32), (50176, 25, 4, 32), (50176, 25, 4, 8), (30976, 49, 10, 32),
    (64, 784, 70, 8), (64, 784, 70, 1024), (64, 3000, 70, 4096), (512, 4096, 512, 256),
    (1, 1, 1, 2), (7, 1000, 3, 4), (3, 33, 5000, 16)]


@pytest.mark.parametrize("M,K,N,bk", PLAN_SHAPES)
@pytest.mark.parametrize("W", [8, 4, 32])
def test_plan_covers_every_chunk_and_tile_once(M, K, N, bk, W):
    p = sc_plan(M, N, K, bk, W, H100_SMS)
    # K: every 32-leaf chunk in exactly one split, no split empty
    chunks = -(-K // 32)
    assert p["chunks"] == chunks
    owner = np.zeros(chunks, int)
    for s in range(p["n_splits"]):
        lo, hi = s * p["chunks_per_split"], min((s + 1) * p["chunks_per_split"], chunks)
        assert lo < hi
        owner[lo:hi] += 1
    assert np.all(owner == 1)
    # hybrid splits land on tree boundaries; a popcount group divides the tree and a chunk
    if bk <= 32:
        assert (p["chunks_per_split"] * 32) % bk == 0
    assert bk % p["group"] == 0 and 32 % p["group"] == 0 and p["group"] >= min(bk, 32) // 2
    # rows from the smaller operand, the tiles cover every output once
    rows, cols = (N, M) if p["swap"] else (M, N)
    assert (p["rows"], p["cols"]) == (rows, cols) and rows <= cols
    assert p["row_blocks"] * p["mm"] >= rows > (p["row_blocks"] - 1) * p["mm"]
    assert p["col_blocks"] * p["nt"] >= cols > (p["col_blocks"] - 1) * p["nt"]
    assert p["nt"] == 4 * p["cs"] and p["threads"] == p["cs"] * max(W, 2) // 2
    assert 128 <= p["threads"] <= 256 and p["threads"] % 32 == 0
    assert p["ctas"] == p["row_blocks"] * p["col_blocks"] * p["n_splits"]
    depth = bk.bit_length() - 1
    assert smem_bytes(256, W, 32 // W, depth, p["nt"], p["mm"]) <= _MAX_SMEM


def test_plan_fills_the_card_at_decode():
    """At the sc decode step's 2 rows the grid holds ≥ 2 CTAs an SM at every
    projection of phi4 (K split where the output grid is small)."""
    for K, N in ((3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072)):
        p = sc_plan(2, N, K, 32, 8, H100_SMS)
        assert p["ctas"] >= 2 * H100_SMS and p["n_splits"] > 1 and not p["swap"]


def test_plan_reads_only_shapes():
    assert list(inspect.signature(sc_plan).parameters) == ["M", "N", "K", "bk", "W", "n_sm"]
    assert sc_plan(2, 1024, 3072, 32, 8, 132) == sc_plan(2, 1024, 3072, 32, 8, 132)
