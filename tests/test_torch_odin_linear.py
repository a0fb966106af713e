"""The port's ODIN execution modes (``repro_torch.core.odin_linear``) against
the JAX package's ``odin_linear`` on the same x and w and the JAX LUTs.

int8 and sc are held bit for bit (atol 0): the rails are equal integers,
the rail products are exact integers (int8 dot; popcounts of the same
streams), and every float op after them is the same IEEE op in the same
order.  The JAX side runs op by op, as its own tests run it: under ``jit``
XLA turns the scale's division by 255 into a multiplication by a rounded
reciprocal, which moves it by an ulp.  exact mode is a float32 matmul
summed in another order: atol 1e-5.
Drift noise comes from ``jax.random`` on one side and a ``torch.Generator``
on the other, so it is held by its distribution."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import stochastic as jsc
from repro.core.odin_linear import OdinConfig as JaxOdinConfig
from repro.core.odin_linear import get_luts as jax_get_luts
from repro.core.odin_linear import odin_linear as jax_odin_linear
from repro.core.quant import quantize_signed_tworail as jax_tworail
from repro.kernels.sc_mac import sc_matmul_hybrid_ref as jax_hybrid_ref
from repro_torch.bridge import luts_from_numpy
from repro_torch.core import stochastic as sc
from repro_torch.core.odin_linear import OdinConfig, odin_linear
from repro_torch.core.quant import quantize_signed_tworail
from repro_torch.kernels.sc_mac import sc_mac_popcounts, tile_k

JLUTS = jax_get_luts(256, 256, 0)
LUTS = luts_from_numpy(*JLUTS)


def _jax(x, w, **cfg):
    return np.asarray(jax_odin_linear(jnp.asarray(x), jnp.asarray(w), JaxOdinConfig(**cfg)))


def _xw(seed, lead, K, N, unipolar=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(*lead, K)).astype(np.float32)
    if unipolar:
        x = np.maximum(x, 0.0)
    w = (rng.normal(size=(K, N)) * 0.3).astype(np.float32)
    return x, w


CASES = [
    # name, lead dims, K, N, config (shapes shared where they can be: the
    # JAX side compiles each op once per shape)
    ("int8_signed", (3,), 40, 4, dict(mode="int8")),
    ("int8_unipolar", (3,), 40, 4, dict(mode="int8", signed_activations=False)),
    ("int8_round_popcount", (3,), 300, 4, dict(mode="int8", round_popcount=True)),
    ("int8_leading_dims", (1, 3), 40, 4, dict(mode="int8")),
    ("int8_k784", (3,), 784, 4, dict(mode="int8", signed_activations=False)),
    ("sc_signed_b32", (3,), 40, 4, dict(mode="sc")),
    ("sc_unipolar_b32", (3,), 40, 4, dict(mode="sc", signed_activations=False)),
    ("sc_signed_b8", (3,), 40, 4, dict(mode="sc", sc_block_k=8)),
    ("sc_unipolar_b8", (3,), 40, 4, dict(mode="sc", signed_activations=False, sc_block_k=8)),
    ("sc_signed_full", (3,), 40, 4, dict(mode="sc", sc_block_k=0)),
    ("sc_unipolar_full", (3,), 40, 4, dict(mode="sc", signed_activations=False, sc_block_k=0)),
    ("sc_leading_dims", (1, 3), 40, 4, dict(mode="sc", signed_activations=False)),
    ("sc_k300_b32", (3,), 300, 4, dict(mode="sc", signed_activations=False)),
    # K = 784 at block 8 is CNN1's fc2, held in test_torch_cnn.py
    ("sc_k784_b32", (3,), 784, 4, dict(mode="sc", signed_activations=False)),
    ("sc_k784_full", (3,), 784, 4, dict(mode="sc", signed_activations=False, sc_block_k=0)),
]


@pytest.mark.parametrize("name,lead,K,N,cfg", CASES, ids=[c[0] for c in CASES])
def test_modes_bit_identical_to_jax(name, lead, K, N, cfg):
    x, w = _xw(len(name) * 31 + K, lead, K, N, unipolar=not cfg.get("signed_activations", True))
    ours = odin_linear(torch.from_numpy(x), torch.from_numpy(w), OdinConfig(**cfg), luts=LUTS)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (*lead, N)
    np.testing.assert_array_equal(ours.numpy(), _jax(x, w, **cfg))


def test_exact_mode_is_matmul():
    x, w = _xw(6, (8,), 16, 8)
    ours = odin_linear(torch.from_numpy(x), torch.from_numpy(w), OdinConfig())
    np.testing.assert_allclose(ours.numpy(), _jax(x, w), atol=1e-5, rtol=0)


@pytest.mark.parametrize("block_k", [32, 8, 0])
def test_rails_and_popcounts_identical(block_k):
    x, w = _xw(21, (3,), 70, 4)
    x_rails = quantize_signed_tworail(torch.from_numpy(x))
    w_rails = quantize_signed_tworail(torch.from_numpy(w))
    for ours, theirs in ((x_rails, jax_tworail(jnp.asarray(x))),
                         (w_rails, jax_tworail(jnp.asarray(w)))):
        for o, t in zip(ours[:2], theirs[:2]):
            np.testing.assert_array_equal(o.numpy(), np.asarray(t))
        assert ours[2].scale.item() == float(theirs[2].scale)
    a, b = x_rails[0], w_rails[1]                           # a⁺ · w⁻
    bk = tile_k(70, block_k)
    ours = sc_mac_popcounts(a, b, *LUTS, sc.StreamSpec(), block_k)
    hybrid = jax.jit(lambda a, b: jax_hybrid_ref(a, b, *JLUTS, jsc.StreamSpec(), bk))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(hybrid(a.numpy(), b.numpy())))


def test_drift_noise_distribution():
    x, w = _xw(8, (64,), 32, 32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    clean = odin_linear(tx, tw, OdinConfig(mode="int8"))
    cfg = OdinConfig(mode="int8", drift_noise=0.05, drift_seed=3)
    y0 = odin_linear(tx, tw, cfg, drift_step=0)
    mask = clean.abs() > 1e-3
    ratio = (y0 / clean)[mask]
    assert abs(ratio.mean().item() - 1.0) < 0.01            # 2048 draws: σ/√n ≈ 0.001
    assert abs(ratio.std().item() - 0.05) < 0.005
    assert torch.equal(odin_linear(tx, tw, cfg, drift_step=0), y0)   # same step, same pattern
    y1 = odin_linear(tx, tw, cfg, drift_step=1)
    assert not torch.equal(y1, y0)                           # fresh pattern each step
    assert torch.equal(odin_linear(tx, tw, OdinConfig(mode="exact", drift_noise=0.5)),
                       odin_linear(tx, tw, OdinConfig(mode="exact")))


def test_default_luts_are_the_ports_own():
    x, w = _xw(9, (2,), 16, 3, unipolar=True)
    cfg = OdinConfig(mode="sc", signed_activations=False)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    from repro_torch.core.odin_linear import get_luts
    assert torch.equal(odin_linear(tx, tw, cfg), odin_linear(tx, tw, cfg, luts=get_luts(256, 256, 0)))


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown ODIN mode"):
        odin_linear(torch.zeros(2, 3), torch.zeros(3, 2), OdinConfig(mode="fp8"))
