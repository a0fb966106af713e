"""xLSTM's mLSTM and sLSTM cells of the port against the JAX package.

Weights are the JAX package's ``materialize`` of each cell's spec, carried
across by the bridge in float32; inputs are numpy draws.  Shapes and
scales are the JAX suite's (``tests/test_recurrent.py``: d 32 over 4
heads, inputs of scale 0.7).

* Specs: the same shapes and dtypes (``r_zifo`` float32).  Initial states:
  bit for bit (mLSTM's ``m = -1e30``, sLSTM's ``n = 1``).
* ``log σ(f)``: the port's ``logsigmoid`` equals the reference's
  ``-softplus(-f)`` within two float32 ulps, the padded gate ``f = 30``
  included.
* ``mlstm_block``, scan and chunkwise, S ∈ {1, 12, 100} and chunk ∈ {16,
  33, 512} (33 pads 100 to 132; a chunk past S is one chunk of S), with and
  without state: outputs and ``C/n/m`` within 1e-5.  One case is held
  otherwise: the chunkwise form over one chunk of 100 tokens (S = 100,
  chunk 512).  Its decay matrices are exponentials of differences of a
  log-forget sum that reaches ≈ -70, whose float32 ulp is 7.6e-6, so two
  float32 implementations part by ≈ 1e-5 there: the reference's own scan
  and chunkwise forms do on the same input (0.64-1.1e-5 over 12 seeds,
  with and without state; the port's distance to the reference's
  chunkwise 0.78-1.6e-5, at most 0.88 of the bound below).  That case is
  held within 1e-5 plus the reference's own chunkwise-to-scan distance on
  its input.
* ``slstm_block`` with and without state, within 1e-5.
* The port's own mirrors of the JAX suite's recurrent tests: decode
  parity (bf16, atol 3e-2), chunkwise == scan at 1e-4 for chunks 16, 33
  and 512, and finite outputs over 512 tokens at input scale 3.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.nn import module as jmodule
from repro.nn import xlstm as jx
from repro_torch.bridge import params_from_numpy
from repro_torch.nn import module as tmodule
from repro_torch.nn import xlstm as tx
from repro_torch.tree import leaves_with_path

D, H = 32, 4
DH = D // H
TOL = 1e-5


def _params(spec_fn, *args, key=0):
    """(JAX float32 params, the port's float32 params) of one cell."""
    p = jmodule.materialize(spec_fn(*args), jax.random.PRNGKey(key))
    host = jax.tree.map(lambda a: np.asarray(a, np.float32), p)
    return jax.tree.map(jnp.asarray, host), params_from_numpy(host, "cpu")


@pytest.fixture(scope="module")
def mlstm():
    return _params(jx.mlstm_spec, H, D)


@pytest.fixture(scope="module")
def slstm():
    return _params(jx.slstm_spec, H, D, key=1)


def _dtype_name(dt):
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_specs_equal_jax(cell):
    ours = {p: s for p, _, s in leaves_with_path(getattr(tx, f"{cell}_spec")(H, D))}
    theirs = {p: s for p, _, s in leaves_with_path(getattr(jx, f"{cell}_spec")(H, D))}
    assert ours.keys() == theirs.keys()
    for p, s in theirs.items():
        assert tuple(ours[p].shape) == tuple(s.shape), p
        assert _dtype_name(ours[p].dtype) == np.dtype(s.dtype).name, p
        assert ours[p].init == s.init, p
    if cell == "slstm":
        assert ours["['r_zifo']"].dtype == torch.float32
    assert tmodule.count_params(getattr(tx, f"{cell}_spec")(H, D)) == jmodule.count_params(
        getattr(jx, f"{cell}_spec")(H, D))


def test_initial_states_bit_for_bit():
    pairs = [(tx.init_mlstm_state(H, D, 3), jx.init_mlstm_state(H, D, 3)),
             (tx.init_slstm_state(D, 3), jx.init_slstm_state(D, 3))]
    for ours, theirs in pairs:
        assert ours.keys() == theirs.keys()
        for k in ours:
            assert ours[k].dtype == torch.float32
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]))
    assert (pairs[0][0]["m"] == -1e30).all() and (pairs[1][0]["n"] == 1).all()


def test_log_forget_gate_equals_jax_softplus():
    """``F.logsigmoid(f)`` against the reference's ``-jax.nn.softplus(-f)``:
    within two float32 ulps, at the pad value 30, past ``F.softplus``'s
    threshold of 20 on either side, at 0 and the -1e30 input gate, and on
    100,000 normal draws of scale 10.  XLA flushes a subnormal result to 0
    (log σ(88) = -6e-39), hence the smallest normal float32 as atol."""
    f = np.concatenate([np.array([30.0, -30.0, 20.5, -20.5, 0.0, 88.0, -88.0, -1e30],
                                 np.float32),
                        np.random.default_rng(0).normal(0, 10, 100_000).astype(np.float32)])
    ours = torch.nn.functional.logsigmoid(torch.from_numpy(f)).numpy()
    theirs = np.asarray(-jax.nn.softplus(-jnp.asarray(f)))
    np.testing.assert_allclose(ours, theirs, rtol=2.0 ** -22,
                               atol=np.finfo(np.float32).tiny)
    assert ours[0] == theirs[0] and -1e-13 < ours[0] < 0       # the padded gate


def _state(rng, batch):
    return {"C": (rng.normal(size=(batch, H, DH, DH)) * 0.5).astype(np.float32),
            "n": (rng.normal(size=(batch, H, DH)) * 0.5).astype(np.float32),
            "m": rng.normal(size=(batch, H)).astype(np.float32)}


def _run_mlstm(params, x, st, impl, chunk, jax_side):
    if jax_side:
        out, new = jx.mlstm_block(params, jnp.asarray(x), H,
                                  state=None if st is None else jax.tree.map(jnp.asarray, st),
                                  impl=impl, chunk=chunk)
        return np.asarray(out), None if new is None else {k: np.asarray(v)
                                                         for k, v in new.items()}
    out, new = tx.mlstm_block(params, torch.from_numpy(x), H,
                              state=None if st is None else {k: torch.from_numpy(v)
                                                             for k, v in st.items()},
                              impl=impl, chunk=chunk)
    return out.numpy(), None if new is None else {k: v.numpy() for k, v in new.items()}


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk", [16, 33, 512])
@pytest.mark.parametrize("S", [1, 12, 100])
@pytest.mark.parametrize("impl", ["scan", "chunkwise"])
def test_mlstm_block_matches_jax(mlstm, impl, S, chunk, with_state):
    jp, tp = mlstm
    rng = np.random.default_rng(S * 1000 + chunk + with_state)
    x = (rng.normal(size=(2, S, D)) * 0.7).astype(np.float32)
    st = _state(rng, 2) if with_state else None
    jo, js = _run_mlstm(jp, x, st, impl, chunk, jax_side=True)
    to, ts = _run_mlstm(tp, x, st, impl, chunk, jax_side=False)
    tol = TOL
    if impl == "chunkwise" and min(chunk, S) > 33:
        so, ss = _run_mlstm(jp, x, st, "scan", chunk, jax_side=True)
        own = np.abs(so - jo).max()
        if with_state:
            own = max(own, *(np.abs(ss[k] - js[k]).max() for k in js))
        tol = TOL + own
    np.testing.assert_allclose(to, jo, atol=tol, rtol=0)
    assert (ts is None) == (js is None) == (not with_state)
    if with_state:
        for k in ("C", "n", "m"):
            np.testing.assert_allclose(ts[k], js[k], atol=tol, rtol=0, err_msg=k)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 12])
def test_slstm_block_matches_jax(slstm, S, with_state):
    jp, tp = slstm
    rng = np.random.default_rng(S + 7 * with_state)
    x = (rng.normal(size=(2, S, D)) * 0.7).astype(np.float32)
    st = None
    if with_state:
        st = {"c": rng.normal(size=(2, D)).astype(np.float32),
              "n": (1 + np.abs(rng.normal(size=(2, D)))).astype(np.float32),
              "h": (rng.normal(size=(2, D)) * 0.5).astype(np.float32),
              "m": rng.normal(size=(2, D)).astype(np.float32)}
    jo, js = jx.slstm_block(jp, jnp.asarray(x),
                            state=None if st is None else jax.tree.map(jnp.asarray, st))
    to, ts = tx.slstm_block(tp, torch.from_numpy(x),
                            state=None if st is None else {k: torch.from_numpy(v)
                                                           for k, v in st.items()})
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=0)
    assert (ts is None) == (js is None) == (not with_state)
    if with_state:
        for k in ("c", "n", "h", "m"):
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), atol=TOL, rtol=0,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# the JAX suite's recurrent tests, on the port
# ---------------------------------------------------------------------------

def _bf16_params(spec, seed=0):
    return tmodule.materialize(spec, torch.Generator().manual_seed(seed), "cpu")


def _x(shape, scale, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(torch.bfloat16)


def test_mlstm_decode_parity():
    p = _bf16_params(tx.mlstm_spec(H, D))
    B, S = 2, 12
    x = _x((B, S, D), 0.5, 1)
    full, _ = tx.mlstm_block(p, x, H)
    st = tx.init_mlstm_state(H, D, B)
    outs = []
    for t in range(S):
        o, st = tx.mlstm_block(p, x[:, t:t + 1], H, state=st)
        outs.append(o)
    np.testing.assert_allclose(full.float().numpy(), torch.cat(outs, 1).float().numpy(),
                               atol=3e-2)


def test_slstm_decode_parity():
    d = 24
    p = _bf16_params(tx.slstm_spec(2, d))
    B, S = 2, 9
    x = _x((B, S, d), 0.5, 2)
    full, _ = tx.slstm_block(p, x)
    st = tx.init_slstm_state(d, B)
    outs = []
    for t in range(S):
        o, st = tx.slstm_block(p, x[:, t:t + 1], state=st)
        outs.append(o)
    np.testing.assert_allclose(full.float().numpy(), torch.cat(outs, 1).float().numpy(),
                               atol=3e-2)


def test_mlstm_stability_long_sequence():
    d, h = 16, 2
    p = _bf16_params(tx.mlstm_spec(h, d))
    y, _ = tx.mlstm_block(p, _x((1, 512, d), 3.0, 3), h)
    assert bool(torch.isfinite(y.float()).all())


@pytest.mark.parametrize("chunk", [16, 33, 512])
def test_mlstm_chunkwise_equals_scan(chunk):
    p = _bf16_params(tx.mlstm_spec(H, D))
    B, S = 2, 100
    x = _x((B, S, D), 0.7, 1)
    y_seq, _ = tx.mlstm_block(p, x, H, impl="scan")
    y_chk, _ = tx.mlstm_block(p, x, H, impl="chunkwise", chunk=chunk)
    np.testing.assert_allclose(y_seq.float().numpy(), y_chk.float().numpy(), atol=1e-4)
    st = tx.init_mlstm_state(H, D, B)
    _, s1 = tx.mlstm_block(p, x, H, state=st, impl="scan")
    _, s2 = tx.mlstm_block(p, x, H, state=st, impl="chunkwise", chunk=chunk)
    for k in ("C", "n", "m"):
        np.testing.assert_allclose(s1[k].numpy(), s2[k].numpy(), atol=1e-4, err_msg=k)
