"""The port's stochastic-number core and quantizers (``repro_torch.core``)
against the JAX package's, on the same numpy inputs and on the JAX LUTs
carried across with ``luts_from_numpy``.  Everything here is integer or
elementwise IEEE arithmetic, so every comparison is exact (tolerance 0)."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import quant as jquant
from repro.core import stochastic as jsc
from repro.core.odin_linear import get_luts as jax_get_luts
from repro_torch.bridge import luts_from_numpy
from repro_torch.core import quant, stochastic as sc
from repro_torch.core.odin_linear import get_luts

SPEC = sc.StreamSpec(256, 256)
JSPEC = jsc.StreamSpec(256, 256)
JLUTS = jax_get_luts(256, 256, 0)
LUT_A, LUT_W, SELECTS = luts_from_numpy(*JLUTS)

# jit: one compile per shape instead of one per eager op
jax_sc_matmul = jax.jit(functools.partial(jsc.sc_matmul, spec=JSPEC))
jax_mac_tree = jax.jit(lambda v, lut, sel: jsc.sc_mac_tree(jsc.b_to_s(v, lut), sel))


# ---------------------------------------------------------------------------
# packing and the bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,words", [(0, 1), (1, 2), (2, 4), (3, 8)])
def test_pack_unpack_roundtrip_and_jax_bits(seed, words):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (3, words * 32)).astype(bool)
    packed = sc.pack_bits(torch.as_tensor(bits))
    assert packed.dtype == torch.int32 and packed.shape == (3, words)
    assert torch.equal(sc.unpack_bits(packed), torch.as_tensor(bits))
    np.testing.assert_array_equal(packed.numpy().view(np.uint32),
                                  np.asarray(jsc.pack_bits(jnp.asarray(bits))))


def test_popcount32_matches_bit_count():
    rng = np.random.default_rng(5)
    words = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    words[:4] = [0, 1, 2**31, 2**32 - 1]
    expect = np.array([bin(int(x)).count("1") for x in words])
    got = sc.popcount32(torch.from_numpy(words.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), expect)


def test_luts_cross_bit_for_bit():
    for ours, theirs in zip((LUT_A, LUT_W, SELECTS), JLUTS):
        assert ours.dtype == torch.int32
        np.testing.assert_array_equal(ours.numpy().view(np.uint32), np.asarray(theirs))


# ---------------------------------------------------------------------------
# the port's own LUTs (torch.Generator draws)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stream_len,n_levels,seed", [(256, 256, 0), (128, 128, 3)])
def test_own_lut_exact_density_and_nested(stream_len, n_levels, seed):
    lut_a, lut_w, sel = get_luts(stream_len, n_levels, seed)
    spec = sc.StreamSpec(stream_len, n_levels)
    assert lut_a.shape == (n_levels, spec.n_words) and sel.shape == (20, spec.n_words)
    vals = torch.arange(n_levels)
    for lut in (lut_a, lut_w):
        assert torch.equal(sc.s_to_b(sc.b_to_s(vals, lut)), vals.int())   # row v has v ones
        b = sc.unpack_bits(lut)
        assert not (b[:-1] & ~b[1:]).any()                                 # rows nested
    assert not torch.equal(lut_a, lut_w)                                    # drawn apart
    assert torch.equal(sc.s_to_b(sel), torch.full((20,), stream_len // 2, dtype=torch.int32))


def test_own_luts_same_on_every_call_and_device_copy():
    a1 = get_luts(256, 256, 0)
    a2 = get_luts(256, 256, 0, device=torch.device("cpu"))
    for x, y in zip(a1, a2):
        assert torch.equal(x, y)
    assert not torch.equal(get_luts(256, 256, 1)[0], a1[0])


# ---------------------------------------------------------------------------
# arithmetic against the JAX package on its LUTs
# ---------------------------------------------------------------------------

def test_b_to_s_and_s_to_b_match_jax():
    vals = np.arange(256)
    for ours, theirs in ((LUT_A, JLUTS[0]), (LUT_W, JLUTS[1])):
        s = sc.b_to_s(torch.as_tensor(vals), ours)
        js = jsc.b_to_s(jnp.asarray(vals), theirs)
        np.testing.assert_array_equal(s.numpy().view(np.uint32), np.asarray(js))
        np.testing.assert_array_equal(sc.s_to_b(s).numpy(), np.asarray(jsc.s_to_b(js)))


@pytest.mark.parametrize("k", [1, 3, 8, 24])
def test_mac_tree_matches_jax(k):
    rng = np.random.default_rng(k)
    vals = rng.integers(0, 256, k)
    ours = sc.sc_mac_tree(sc.b_to_s(torch.as_tensor(vals), LUT_A), SELECTS)
    theirs = jax_mac_tree(jnp.asarray(vals), JLUTS[0], JLUTS[2])
    np.testing.assert_array_equal(ours.numpy().view(np.uint32), np.asarray(theirs))


def test_sc_mux_and_mul_match_jax():
    rng = np.random.default_rng(9)
    a, b, s = (rng.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32) for _ in range(3))
    ta, tb, ts = (torch.from_numpy(x.view(np.int32)) for x in (a, b, s))
    np.testing.assert_array_equal(sc.sc_mux(ta, tb, ts).numpy().view(np.uint32),
                                  np.asarray(jsc.sc_mux(a, b, s)))
    np.testing.assert_array_equal(sc.sc_mul(ta, tb).numpy().view(np.uint32), a & b)
    np.testing.assert_array_equal(sc.sc_not(ta).numpy().view(np.uint32), ~a)


@pytest.mark.parametrize("M,K,N", [(1, 1, 1), (6, 24, 5), (3, 33, 7)])
def test_sc_matmul_and_expected_match_jax(M, K, N):
    rng = np.random.default_rng(M * 100 + K)
    a = rng.integers(0, 256, (M, K))
    w = rng.integers(0, 256, (K, N))
    ours = sc.sc_matmul(torch.as_tensor(a), torch.as_tensor(w), LUT_A, LUT_W, SELECTS, SPEC)
    theirs = jax_sc_matmul(jnp.asarray(a, jnp.int32), jnp.asarray(w, jnp.int32), *JLUTS)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    e_ours = sc.expected_matmul(torch.as_tensor(a), torch.as_tensor(w), SPEC)
    e_theirs = jsc.expected_matmul(jnp.asarray(a, jnp.int32), jnp.asarray(w, jnp.int32), JSPEC)
    np.testing.assert_array_equal(e_ours.numpy(), np.asarray(e_theirs))


def test_tree_depth_matches_jax():
    ks = (1, 2, 3, 4, 5, 8, 9, 784, 1024, 1025)
    assert [sc.tree_depth(k) for k in ks] == [jsc.tree_depth(k) for k in ks]


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_levels", [256, 128])
def test_quantizers_match_jax_bit_for_bit(n_levels):
    rng = np.random.default_rng(n_levels)
    x = rng.normal(size=(16, 40)).astype(np.float32)
    pos, neg, qp = quant.quantize_signed_tworail(torch.as_tensor(x), n_levels)
    jpos, jneg, jqp = jquant.quantize_signed_tworail(jnp.asarray(x), n_levels)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(neg.numpy(), np.asarray(jneg))
    assert qp.scale.item() == float(jqp.scale)
    assert not ((pos > 0) & (neg > 0)).any()
    u = np.abs(x)
    q, up = quant.quantize_unipolar(torch.as_tensor(u), n_levels)
    jq, jup = jquant.quantize_unipolar(jnp.asarray(u), n_levels)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(quant.dequantize(q, up).numpy(),
                                  np.asarray(jquant.dequantize(jq, jup)))


def test_round_half_to_even_like_jax():
    x = np.array([0.5, 1.5, 2.5, 254.5, 255.0], np.float32)   # max 255: scale 1.0
    q, qp = quant.quantize_unipolar(torch.as_tensor(x), 256)
    jq, _ = jquant.quantize_unipolar(jnp.asarray(x), 256)
    assert qp.scale.item() == 1.0
    assert q.tolist() == [0, 2, 2, 254, 255]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
