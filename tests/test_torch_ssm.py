"""The port's selective SSM block and time scan against the JAX package's.

Same numpy parameters and inputs (float32) through ``repro.nn.ssm.ssm_block``
and ``repro_torch.nn.ssm.ssm_block``: a prefill with no state, a prefill
from a state, a single-token decode, and 200 tokens (one 128-step chunk of
``chunked_scan`` and its 72-step tail).  ``y``, ``h`` and ``conv`` agree
within atol 1e-5: the two frameworks sum the projections and the per-step
``C·h`` contraction in different orders, in float32."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.base import SSMConfig as JSSMConfig
from repro.nn import scan_utils as jscan
from repro.nn import ssm as jssm
from repro_torch.configs.base import SSMConfig
from repro_torch.nn import scan_utils as tscan
from repro_torch.nn import ssm as tssm

D_MODEL, B = 64, 2
CFG = dict(state_dim=4, expand=2, conv_dim=4)
ATOL = 1e-5


def _params(rng):
    di = CFG["expand"] * D_MODEL
    r, n = max(1, D_MODEL // 16), CFG["state_dim"]

    def w(*shape, scale):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return {"in_proj": w(D_MODEL, 2 * di, scale=D_MODEL ** -0.5),
            "conv_w": w(CFG["conv_dim"], di, scale=0.5),
            "x_proj": w(di, r + 2 * n, scale=di ** -0.5),
            "dt_proj": w(r, di, scale=r ** -0.5),
            "dt_bias": w(di, scale=0.5),
            "A_log": w(di, n, scale=0.5),
            "D": 1.0 + w(di, scale=0.1),
            "out_proj": w(di, D_MODEL, scale=di ** -0.5)}


def _run_both(p, x, state):
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jst = None if state is None else {k: jnp.asarray(v) for k, v in state.items()}
    tst = None if state is None else {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    jy, js = jssm.ssm_block(jp, jnp.asarray(x), JSSMConfig(**CFG), state=jst)
    ty, ts = tssm.ssm_block(tp, torch.from_numpy(x), SSMConfig(**CFG), state=tst)
    if state is not None:
        # the new state is new tensors: the caller's state is left as it was
        for k, v in state.items():
            np.testing.assert_array_equal(tst[k].numpy(), v)
    return np.asarray(jy), js, ty.numpy(), ts


@pytest.mark.parametrize("S,with_state", [(12, False), (12, True), (1, True), (200, True)],
                         ids=["prefill_no_state", "prefill_from_state", "decode",
                              "s200_chunk_and_tail"])
def test_ssm_block_matches_jax(S, with_state):
    rng = np.random.default_rng(S)
    p = _params(rng)
    x = rng.normal(size=(B, S, D_MODEL)).astype(np.float32)
    state = None
    if with_state:
        di = CFG["expand"] * D_MODEL
        state = {"h": rng.normal(size=(B, di, CFG["state_dim"])).astype(np.float32),
                 "conv": rng.normal(size=(B, CFG["conv_dim"] - 1, di)).astype(np.float32)}
    jy, js, ty, ts = _run_both(p, x, state)
    assert ty.shape == jy.shape == (B, S, D_MODEL)
    np.testing.assert_allclose(ty, jy, atol=ATOL, rtol=0)
    if with_state:
        for k in ("h", "conv"):
            assert ts[k].dtype == torch.float32
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), atol=ATOL, rtol=0)
    else:
        assert ts is None and js is None


@pytest.mark.parametrize("S,chunk", [(20, 7), (5, 128), (14, 7)])
def test_chunked_scan_matches_jax(S, chunk):
    """An order-sensitive step: chunks then the tail, as the JAX scan runs."""
    rng = np.random.default_rng(S)
    xs = rng.normal(size=(S, 3)).astype(np.float32)
    ws = rng.normal(size=(S,)).astype(np.float32)

    def jstep(c, inp):
        x, w = inp
        c = jnp.tanh(c * w + x)
        return c, c.sum()

    def tstep(c, inp):
        x, w = inp
        c = torch.tanh(c * w + x)
        return c, c.sum()

    jc, jys = jscan.chunked_scan(jstep, jnp.zeros(3), (jnp.asarray(xs), jnp.asarray(ws)),
                                 chunk=chunk, checkpoint=False)
    tc, tys = tscan.chunked_scan(tstep, torch.zeros(3),
                                 [torch.from_numpy(xs), torch.from_numpy(ws)], chunk=chunk)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(tys.numpy(), np.asarray(jys), atol=1e-6)
