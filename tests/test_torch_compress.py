"""The port's int8 stochastic-rounding gradient codec (``optim/compress.py``)
against the JAX package's: given JAX's uniforms, ``compress_int8`` gives
the same int8 codes and float32 scales bit for bit, and ``decompress_int8``
the same values; drawn from a ``torch.Generator`` the rounding is unbiased."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.optim import compress as jcompress
from repro_torch.optim import compress


@pytest.mark.parametrize("shape,block", [((3, 700), 256), ((1000,), 256), ((2, 5, 256), 256),
                                         ((4, 3), 256), ((6, 130), 64)])
def test_compress_matches_jax_bit_for_bit(shape, block):
    """Padded and exact trailing axes, a block of zeros (its scale 0, its codes
    0) and values at the ±127 ends.  JAX runs op by op (eager), so its
    division by 127 is a true division, as the port's is."""
    rng = np.random.default_rng(sum(shape))
    g = rng.standard_normal(shape).astype(np.float32)
    g[..., :block] = 0.0 if len(shape) > 1 else g[..., :block]
    g.reshape(-1)[-1] = 1e3
    key = jax.random.PRNGKey(len(shape))
    q, s = jcompress.compress_int8(jnp.asarray(g), key, block)
    nb = -(-shape[-1] // block)
    u = np.asarray(jax.random.uniform(key, (*shape[:-1], nb, block)))
    tq, ts = compress.compress_int8(torch.from_numpy(g), block=block,
                                    uniforms=torch.from_numpy(u.copy()))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))
    np.testing.assert_array_equal(compress.decompress_int8(tq, ts, block).numpy(),
                                  np.asarray(jcompress.decompress_int8(q, s, block)))


def test_compress_with_a_generator_is_unbiased():
    """The mean of 400 draws of the decompressed gradient is within 4
    standard errors of the gradient (each draw errs by under one level,
    scale = max|g|/127, with a variance of at most a quarter level²)."""
    g = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 300)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([compress.decompress_int8(*compress.compress_int8(g, gen))
                         for _ in range(400)])
    level = g.abs().amax(dim=-1, keepdim=True) / 127
    assert ((draws - g).abs() <= level + 1e-6).all()
    assert ((draws.mean(0) - g).abs() <= 4 * 0.5 * level / 20).all()
