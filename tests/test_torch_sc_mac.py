"""The port's stochastic MAC array (``repro_torch.kernels.sc_mac``; its plain
PyTorch version, which the CPU runs) against the JAX package's Pallas
kernel in interpret mode and its oracles, on the same numpy operands and
the JAX LUTs.  Mirrors tests/test_kernels.py: the popcounts are integers
and are held exactly; the hybrid wrapper's float32 rescale is held bit for
bit.  The CUDA kernel is held against the same plain version on the card
by chip_smoke.py."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import stochastic as jsc
from repro.core.odin_linear import get_luts as jax_get_luts
from repro.kernels.sc_mac import sc_matmul_hybrid_ref as jax_hybrid_ref
from repro.kernels.sc_mac import sc_matmul_pallas
from repro.kernels.sc_mac.ref import ranks_from_lut as jax_ranks_from_lut
from repro_torch.bridge import luts_from_numpy
from repro_torch.core import stochastic as sc
from repro_torch.kernels.sc_mac import (ranks_from_lut, sc_mac_plain, sc_mac_popcounts,
                                        sc_matmul_fused, sc_matmul_hybrid_ref,
                                        sc_matmul_tree_ref, tile_k)

SPEC = sc.StreamSpec(256, 256)
JSPEC = jsc.StreamSpec(256, 256)
JLUTS = jax_get_luts(256, 256, 0)
LUTS = luts_from_numpy(*JLUTS)


def _operands(rng, M, K, N, dtype, levels=256):
    a = rng.integers(0, levels, (M, K)).astype(dtype)
    w = rng.integers(0, levels, (K, N)).astype(dtype)
    return a, w


@pytest.mark.parametrize("M,K,N", [(1, 1, 1), (3, 17, 5), (8, 64, 8),
                                   (5, 33, 11), (16, 128, 4)])
@pytest.mark.parametrize("dtype", ["uint8", "int32"])
def test_tree_regime_exact(M, K, N, dtype):
    rng = np.random.default_rng(M * 1000 + K * 10 + N)
    a, w = _operands(rng, M, K, N, dtype)
    pal = np.asarray(sc_matmul_pallas(jnp.asarray(a), jnp.asarray(w), *JLUTS, JSPEC,
                                      interpret=True))
    ta, tw = torch.as_tensor(a), torch.as_tensor(w)
    ours = sc_matmul_fused(ta, tw, *LUTS, SPEC)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), pal)
    np.testing.assert_array_equal(sc_matmul_tree_ref(ta, tw, *LUTS, SPEC).numpy(), pal)
    np.testing.assert_array_equal(sc.sc_matmul(ta, tw, *LUTS, SPEC).numpy(), pal)


@pytest.mark.parametrize("M,K,N,max_tree_k", [(4, 70, 6, 32), (2, 200, 3, 64)])
def test_hybrid_regime(M, K, N, max_tree_k):
    rng = np.random.default_rng(7)
    a, w = _operands(rng, M, K, N, "int32")
    ja, jw = jnp.asarray(a), jnp.asarray(w)
    hybrid = jax.jit(functools.partial(jax_hybrid_ref, spec=JSPEC, block_k=max_tree_k))
    jref = np.asarray(hybrid(ja, jw, *JLUTS))
    ta, tw = torch.as_tensor(a), torch.as_tensor(w)
    pops = sc_matmul_hybrid_ref(ta, tw, *LUTS, SPEC, max_tree_k)
    np.testing.assert_array_equal(pops.numpy(), jref)                      # exact popcounts
    np.testing.assert_array_equal(
        sc_mac_popcounts(ta, tw, *LUTS, SPEC, max_tree_k).numpy(), jref)
    pal = np.asarray(sc_matmul_pallas(ja, jw, *JLUTS, JSPEC, interpret=True,
                                      max_tree_k=max_tree_k))
    ours = sc_matmul_fused(ta, tw, *LUTS, SPEC, max_tree_k=max_tree_k)
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), pal)                       # same rescale


def test_nondefault_stream_geometry():
    spec, jspec = sc.StreamSpec(128, 128), jsc.StreamSpec(128, 128)
    jluts = jax_get_luts(128, 128, 3)
    rng = np.random.default_rng(0)
    a, w = _operands(rng, 4, 12, 4, "int32", levels=128)
    pal = np.asarray(sc_matmul_pallas(jnp.asarray(a), jnp.asarray(w), *jluts, jspec,
                                      interpret=True))
    ours = sc_matmul_fused(torch.as_tensor(a), torch.as_tensor(w), *luts_from_numpy(*jluts), spec)
    np.testing.assert_array_equal(ours.numpy(), pal)


def test_ranks_roundtrip():
    ranks = ranks_from_lut(LUTS[0], 256)
    assert ranks.shape == (8, 32)
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(jax_ranks_from_lut(JLUTS[0], 256)))
    # comparator streams rebuilt from the ranks == the LUT rows
    bits = torch.arange(256)[:, None, None] > ranks[None]
    rebuilt = sc.pack_bits(bits.reshape(256, -1))
    assert torch.equal(rebuilt, LUTS[0])


def test_block_k_at_or_above_khat_is_the_full_tree():
    rng = np.random.default_rng(11)
    a, w = _operands(rng, 6, 20, 5, "uint8")
    ta, tw = torch.as_tensor(a), torch.as_tensor(w)
    tree = sc_matmul_tree_ref(ta, tw, *LUTS, SPEC)
    for block_k in (0, 32, 64):
        assert torch.equal(sc_mac_popcounts(ta, tw, *LUTS, SPEC, block_k), tree)


@pytest.mark.parametrize("K,block_k,leaves", [(25, 8, 8), (25, 0, 32), (25, 32, 32), (25, 64, 32),
                                              (1, 0, 2), (1, 8, 2), (784, 32, 32), (784, 0, 1024)])
def test_tile_k_picks_the_regime(K, block_k, leaves):
    """``tile_k``: block_k leaves in the hybrid regime, else one tree of K̂;
    ``sc_mac_plain`` follows it."""
    assert tile_k(K, block_k) == leaves
    if K <= 25:
        rng = np.random.default_rng(K + block_k)
        ta, tw = (torch.as_tensor(t) for t in _operands(rng, 3, K, 2, "uint8"))
        want = (sc_matmul_tree_ref(ta, tw, *LUTS, SPEC) if leaves == 1 << sc.tree_depth(K)
                else sc_matmul_hybrid_ref(ta, tw, *LUTS, SPEC, leaves))
        assert torch.equal(sc_mac_plain(ta, tw, *LUTS, SPEC, block_k), want)


def test_full_tree_past_2048_stays_one_tree():
    """block_k 0 is one MUX tree over K̂ at any depth; the JAX
    ``sc_matmul_pallas`` wrapper would tile it at 2048, which the port's
    ``odin_linear`` does not copy."""
    rng = np.random.default_rng(13)
    a, w = _operands(rng, 2, 2100, 3, "uint8")
    ta, tw = torch.as_tensor(a), torch.as_tensor(w)
    tree = sc_mac_popcounts(ta, tw, *LUTS, SPEC, 0)
    assert torch.equal(tree, sc.sc_matmul(ta, tw, *LUTS, SPEC))
    tiled = sc_matmul_fused(ta, tw, *LUTS, SPEC, max_tree_k=2048)
    assert tiled.dtype == torch.float32 and not torch.equal(tiled, tree.float())


def test_row_chunking_changes_no_bit(monkeypatch):
    from repro_torch.kernels.sc_mac import ref
    rng = np.random.default_rng(12)
    a, w = _operands(rng, 9, 40, 3, "uint8")
    ta, tw = torch.as_tensor(a), torch.as_tensor(w)
    whole_tree = sc_matmul_tree_ref(ta, tw, *LUTS, SPEC)
    whole_hyb = sc_matmul_hybrid_ref(ta, tw, *LUTS, SPEC, 8)
    monkeypatch.setattr(ref, "_CHUNK_ELEMS", 2 * 3 * 8 * 8)   # tree: 1 row a chunk, hybrid: 2
    assert torch.equal(sc_matmul_tree_ref(ta, tw, *LUTS, SPEC), whole_tree)
    assert torch.equal(sc_matmul_hybrid_ref(ta, tw, *LUTS, SPEC, 8), whole_hyb)


def test_cuda_path_rejects_cpu_tensors():
    from repro_torch.kernels.sc_mac import sc_mac_cuda
    a = torch.zeros((2, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sc_mac_cuda(a, a.T.contiguous(), *LUTS, block_k=4)
    assert sc_mac_cuda.launches == 0
