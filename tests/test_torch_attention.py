"""``_paged_gqa_core`` of the port against the JAX package's, on the same
numpy q/k/v, pools, tables and positions (float32): plain decode, chunked
prefill, a speculative verify tile that overhangs the table span, and the
mixed tile with pad rows, an idle slot and decode rows.  Outputs agree within
the paged kernel's bound (3e-5); the pools agree exactly, since the core
only copies K/V rows into them.  The write-off block (the pool's last) is
left out of the pool comparison: pad rows collide there, and neither
framework fixes which colliding write lands."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.base import AttnConfig
from repro.nn import attention as jattn
from repro_torch.configs.base import AttnConfig as TAttnConfig
from repro_torch.nn import attention as tattn

B, H, HKV, D, BS, P = 3, 6, 2, 16, 4, 4
N = B * P + 2


def _setup(seed, S, pos, int8=False):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, S, H, D)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(B, S, HKV, D)) * 0.5).astype(np.float32)
    v = (rng.normal(size=(B, S, HKV, D)) * 0.5).astype(np.float32)
    dt = np.int8 if int8 else np.float32
    if int8:
        kp = rng.integers(-127, 128, (N + 1, BS, HKV, D)).astype(dt)
        vp = rng.integers(-127, 128, (N + 1, BS, HKV, D)).astype(dt)
    else:
        kp = (rng.normal(size=(N + 1, BS, HKV, D)) * 0.5).astype(dt)
        vp = (rng.normal(size=(N + 1, BS, HKV, D)) * 0.5).astype(dt)
    tables = rng.permutation(N)[:B * P].reshape(B, P).astype(np.int32)
    return q, k, v, kp, vp, tables, np.asarray(pos, np.int32)


def _run_both(q, k, v, kp, vp, tables, pos, positions, window=0, **kw):
    acfg = dict(kind="gqa", n_heads=H, n_kv_heads=HKV, d_head=D, window=window)
    jcache = {"k_pool": jnp.asarray(kp), "v_pool": jnp.asarray(vp), "pos": jnp.asarray(pos)}
    jkw = {n: (jnp.asarray(a) if isinstance(a, np.ndarray) else a) for n, a in kw.items()}
    jo, jc = jattn._paged_gqa_core(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), AttnConfig(**acfg),
        jnp.asarray(positions), jcache, jnp.asarray(tables), **jkw)
    tcache = {"k_pool": torch.from_numpy(kp.copy()), "v_pool": torch.from_numpy(vp.copy()),
              "pos": torch.from_numpy(pos)}
    tkw = {n: (torch.from_numpy(a) if isinstance(a, np.ndarray) else a) for n, a in kw.items()}
    to, tc = tattn._paged_gqa_core(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), TAttnConfig(**acfg),
        torch.from_numpy(positions), tcache, torch.from_numpy(tables), **tkw)
    return (np.asarray(jo), {n: np.asarray(a) for n, a in jc.items()},
            to.numpy(), {n: a.numpy() for n, a in tc.items()})


def _check(jo, jc, to, tc):
    np.testing.assert_allclose(to, jo, atol=3e-5, rtol=1e-4)
    np.testing.assert_array_equal(tc["pos"], jc["pos"])
    for leaf in ("k_pool", "v_pool"):
        np.testing.assert_array_equal(tc[leaf][:-1], jc[leaf][:-1])


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("S,pos,window,spec", [
    (1, [5, 0, 15], 0, False),          # plain decode (paged kernel)
    (1, [7, 3, 12], 5, False),          # decode under a sliding window
    (5, [0, 4, 9], 0, False),           # chunked prefill (gather + sdpa)
    (3, [6, 14, 2], 0, True),           # verify tile; slot 1 overhangs the span
])
def test_core_matches_jax(S, pos, window, spec, int8):
    q, k, v, kp, vp, tables, pos = _setup(S * 10 + len(pos), S, pos, int8)
    positions = pos[:, None] + np.arange(S, dtype=np.int32)[None]
    jo, jc, to, tc = _run_both(q, k, v, kp, vp, tables, pos, positions,
                               window=window, spec_decode=spec)
    _check(jo, jc, to, tc)


@pytest.mark.parametrize("int8", [False, True])
def test_mixed_tile_matches_jax(int8):
    """Slot 0 decodes (q_len 1, kernel numerics), slot 1 prefills 3 of the 4
    columns (one pad row; its last row overhangs the table span), slot 2 is
    idle (q_len 0, all pad rows)."""
    S = 4
    q, k, v, kp, vp, tables, pos = _setup(11, S, [9, 14, 5], int8)
    q_lens = np.asarray([1, 3, 0], np.int32)
    q_decode = np.asarray([True, False, False])
    positions = (pos + q_lens - S)[:, None] + np.arange(S, dtype=np.int32)[None]
    jo, jc, to, tc = _run_both(q, k, v, kp, vp, tables, pos, positions,
                               q_lens=q_lens, q_decode=q_decode)
    np.testing.assert_allclose(to[0, -1], jo[0, -1], atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(to[1, 1:], jo[1, 1:], atol=3e-5, rtol=1e-4)
    np.testing.assert_array_equal(tc["pos"], jc["pos"])
    for leaf in ("k_pool", "v_pool"):
        np.testing.assert_array_equal(tc[leaf][:-1], jc[leaf][:-1])
