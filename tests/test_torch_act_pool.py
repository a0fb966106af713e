"""The port's ``act_pool`` (plain PyTorch version, CPU) against the JAX
package's Pallas kernel in interpret mode and its ``act_pool_ref``, bit for
bit on the same int32 NHWC inputs.

The cases hold the traps of a port: ``jnp.round`` rounds half to even (an
average over a 2×2 window whose sum is 2 mod 4 is an exact .5), the 8-bit
tanh over its whole integer domain, pools of 3 and 4, channel counts that
are not a multiple of the JAX wrapper's block of 8, and the int32
extremes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels.act_pool import act_pool as jax_act_pool
from repro.kernels.act_pool import act_pool_ref
from repro_torch.kernels import act_pool
from repro_torch.kernels.act_pool import act_pool_ref as torch_act_pool_ref

# one compiled program a case, not one per eager op (the ops are exact
# integer and float32 arithmetic, the same under jit)
jax_act_pool_ref = jax.jit(act_pool_ref, static_argnums=(1, 2, 3))
I32 = 2 ** 31 - 1


def _random(shape, lo=-300, hi=600, seed=0):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(np.int32)


def _tanh_domain():
    """Every integer in [-1024, 4096), one per pixel."""
    return np.arange(-1024, 4096, dtype=np.int32).reshape(1, 80, 64, 1)


def _avg_ties():
    """2×2 windows whose ReLU'd sums run over 0..1020: every sum 2 mod 4 is
    a .5 tie of the average (sum 2 → 0.5 → 0, sum 6 → 1.5 → 2)."""
    sums = np.arange(0, 1021)
    win = np.zeros((sums.size, 4), np.int64)
    rest = sums.copy()
    for q in range(4):
        win[:, q] = np.minimum(rest, 255)
        rest -= win[:, q]
    win = np.where(win == 0, -5, win)   # negative inputs the ReLU clips to 0
    x = win.reshape(sums.size, 2, 2).transpose(1, 0, 2).reshape(2, sums.size * 2)
    return x.astype(np.int32).reshape(1, 2, sums.size * 2, 1)


def _extremes():
    x = _random((2, 6, 6, 8), seed=5)
    x[0, ::2] = I32
    x[1, :, ::3] = -I32
    x[0, 1, 1, 1] = -I32 - 1
    return x


# name → (input, pool, act, pool_kind)
CASES = {
    # tests/test_kernels.py's shapes × pool (relu, max) ...
    "b1_4x4_c8_p2": (_random((1, 4, 4, 8), seed=5), 2, "relu", "max"),
    "b2_28x28_c10_p2": (_random((2, 28, 28, 10), seed=66), 2, "relu", "max"),
    "b3_12x12_c16_p3": (_random((3, 12, 12, 16), seed=52), 3, "relu", "max"),
    "b1_6x6_c1_p2": (_random((1, 6, 6, 1), seed=7), 2, "relu", "max"),
    # ... and its act × pool_kind variants
    "relu_avg": (_random((2, 8, 8, 8), -100, 400, 11), 2, "relu", "avg"),
    "tanh_max": (_random((2, 8, 8, 8), -100, 400, 11), 2, "tanh", "max"),
    "tanh_avg": (_random((2, 8, 8, 8), -100, 400, 11), 2, "tanh", "avg"),
    "tanh_domain_p1": (_tanh_domain(), 1, "tanh", "max"),
    "tanh_domain_avg_p2": (_tanh_domain(), 2, "tanh", "avg"),
    "avg_ties_p2": (_avg_ties(), 2, "relu", "avg"),
    "relu_avg_p3": (_random((2, 12, 12, 8), seed=3), 3, "relu", "avg"),
    "tanh_avg_p4": (_random((2, 16, 8, 8), seed=4), 4, "tanh", "avg"),
    "relu_max_p4_c3": (_random((2, 8, 16, 3), seed=8), 4, "relu", "max"),
    "tanh_avg_c3": (_random((1, 6, 6, 3), seed=9), 2, "tanh", "avg"),
    "int32_extremes_relu_max": (_extremes(), 2, "relu", "max"),
    "int32_extremes_relu_avg": (_extremes(), 3, "relu", "avg"),
    "int32_extremes_tanh_avg": (_extremes(), 2, "tanh", "avg"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_act_pool_matches_jax_bit_for_bit(name):
    x, pool, act, kind = CASES[name]
    ours = act_pool(torch.from_numpy(x), pool=pool, act=act, pool_kind=kind)
    assert ours.dtype == torch.int32
    assert tuple(ours.shape) == (x.shape[0], x.shape[1] // pool, x.shape[2] // pool, x.shape[3])
    theirs = np.asarray(jax_act_pool(jnp.asarray(x), pool=pool, act=act, pool_kind=kind))
    ref = np.asarray(jax_act_pool_ref(jnp.asarray(x), pool, act, kind))
    np.testing.assert_array_equal(theirs, ref)
    np.testing.assert_array_equal(ours.numpy(), theirs)
    np.testing.assert_array_equal(
        torch_act_pool_ref(torch.from_numpy(x), pool, act, kind).numpy(), theirs)
    assert int(ours.min()) >= 0 and int(ours.max()) <= 255


def test_avg_ties_round_half_to_even():
    x, pool, act, kind = CASES["avg_ties_p2"]
    out = act_pool(torch.from_numpy(x), pool=pool, act=act, pool_kind=kind)[0, 0, :, 0]
    sums = np.arange(0, 1021)
    np.testing.assert_array_equal(out.numpy(), np.round(sums / 4.0))
    assert out[2].item() == 0 and out[6].item() == 2 and out[10].item() == 2


def test_tanh_saturates_at_222():
    x = torch.arange(200, 240, dtype=torch.int32).reshape(1, 1, 40, 1)
    out = act_pool(x, pool=1, act="tanh")[0, 0, :, 0]
    assert out[222 - 200 - 1].item() < 255 and bool((out[222 - 200:] == 255).all())


@pytest.mark.parametrize("shape,pool", [((1, 5, 4, 2), 2), ((1, 6, 7, 2), 3)])
def test_indivisible_map_raises(shape, pool):
    x = np.zeros(shape, np.int32)
    with pytest.raises(ValueError, match="multiples of pool"):
        act_pool(torch.from_numpy(x), pool=pool)
    with pytest.raises(AssertionError):
        jax_act_pool(jnp.asarray(x), pool=pool)


@pytest.mark.parametrize("kw", [{"act": "gelu"}, {"pool_kind": "min"}])
def test_unknown_act_or_pool_kind_raises(kw):
    with pytest.raises(ValueError, match="need one of"):
        act_pool(torch.zeros((1, 2, 2, 1), dtype=torch.int32), **kw)
