"""The port's MoE block (``repro_torch/nn/moe.py``) against the JAX package's.

Inputs come from numpy seeds; weights from the JAX package's ``materialize``,
carried across by ``repro_torch.bridge``.  ``dispatch_indices`` holds bit for
bit over hypothesis draws (as ``tests/test_moe.py`` draws them); ``moe_block``
holds in float32 within atol 1e-5 — the two frameworks sum the expert
products in different orders — with and without capacity dropping, at
decode (S = 1) and prefill shapes, with shared experts, a biased
aux-loss-free route and each activation, and on exactly tied router scores.
In bfloat16 the two part by a few ulps, measured and bounded in
``test_bf16_difference_to_jax``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.nn import moe as jmoe
from repro.nn.module import materialize as jax_materialize
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import MoEConfig
from repro_torch.core.odin_linear import OdinConfig
from repro_torch.nn import moe as tmoe

D = 64
# the qwen3 smoke config's MoE (8 experts, top-2, d_ff 32, no shared
# experts, no route bias), then the options qwen3 does not use
CASES = {
    "qwen3_smoke": dict(cfg={}, S=7, no_drop=False),
    "qwen3_smoke_no_drop": dict(cfg={}, S=7, no_drop=True),
    "decode_s1": dict(cfg={}, S=1, no_drop=False, B=9),
    "decode_s1_no_drop": dict(cfg={}, S=1, no_drop=True, B=9),
    "drops_shared_bias": dict(cfg=dict(n_shared=1, aux_free_bias=True,
                                       capacity_factor=0.5), S=7, no_drop=False),
    "no_drop_shared_bias": dict(cfg=dict(n_shared=1, aux_free_bias=True,
                                         capacity_factor=0.5), S=7, no_drop=True),
    "relu2_drops": dict(cfg=dict(capacity_factor=0.75), S=6, no_drop=False,
                        act="relu2"),
    "gelu_drops": dict(cfg=dict(capacity_factor=0.75), S=6, no_drop=False, act="gelu"),
    "top1_of_4_drops": dict(cfg=dict(n_experts=4, top_k=1, capacity_factor=0.6), S=9,
                            no_drop=False),
}
BASE = dict(n_experts=8, top_k=2, d_ff=32, aux_free_bias=False)


def _configs(overrides):
    kw = {**BASE, **overrides}
    return JaxMoEConfig(**kw), MoEConfig(**kw)


def _params(jcfg, seed=0):
    """The JAX package's params as numpy; a biased ``route_bias`` when the
    config has one (its init is zeros, which would leave selection alone)."""
    p = jax.tree.map(np.asarray, jax_materialize(jmoe.moe_spec(jcfg, D),
                                                 jax.random.PRNGKey(seed)))
    if "route_bias" in p:
        p["route_bias"] = (np.random.default_rng(seed + 1).normal(size=p["route_bias"].shape)
                           * 0.05).astype(np.float32)
    return p


def _both(p, x, jcfg, tcfg, dtype, **kw):
    """(JAX output, port output) as float32 numpy for params ``p`` and input
    ``x`` in ``dtype`` ("float32" or "bfloat16"); the float32 leaves (router,
    route bias) stay float32 on both sides."""
    if dtype == "float32":
        jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), p)
        tp = params_from_numpy(p, "cpu", dtype=torch.float32)
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    else:
        jp = jax.tree.map(jnp.asarray, p)
        tp = params_from_numpy(p, "cpu")
        jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    assert tp["router"].dtype == torch.float32
    ours = tmoe.moe_block(tp, tx, tcfg, **kw)
    theirs = jmoe.moe_block(jp, jx, jcfg, **kw)
    assert ours.dtype == tx.dtype
    return np.asarray(theirs).astype(np.float32), ours.float().numpy()


@given(st.integers(0, 2**31 - 1), st.integers(2, 16), st.integers(1, 8),
       st.integers(4, 64))
@settings(max_examples=40, deadline=None)
def test_dispatch_indices_bit_for_bit(seed, n_experts, capacity, A):
    ids = np.random.default_rng(seed).integers(0, n_experts, A).astype(np.int32)
    slot, keep = tmoe.dispatch_indices(torch.from_numpy(ids), n_experts, capacity)
    jslot, jkeep = jmoe.dispatch_indices(jnp.asarray(ids), n_experts, capacity)
    assert slot.dtype == torch.int32 and keep.dtype == torch.bool
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    # dropped assignments carry the out-of-bounds sentinel, never slot 0
    assert (slot.numpy()[~keep.numpy()] == n_experts * capacity).all()


@pytest.mark.parametrize("case", list(CASES))
def test_moe_block_matches_jax_float32(case):
    c = CASES[case]
    jcfg, tcfg = _configs(c["cfg"])
    p = _params(jcfg)
    rng = np.random.default_rng(len(case))
    x = rng.normal(size=(c.get("B", 2), c["S"], D)).astype(np.float32)
    theirs, ours = _both(p, x, jcfg, tcfg, "float32", no_drop=c["no_drop"],
                         activation_kind=c.get("act", "swiglu"))
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=0)
    if "drops" in case:
        # the case must really drop: capped capacity differs from drop-free
        _, free = _both(p, x, jcfg, tcfg, "float32", no_drop=True,
                        activation_kind=c.get("act", "swiglu"))
        assert np.abs(free - ours).max() > 1e-3


def test_drop_free_routing_is_chunk_invariant():
    """no_drop: each token's output is the same whether it is routed alone or
    with the rest of its sequence (the serving invariant); with capped
    capacity, the full pass drops what a one-token pass keeps."""
    jcfg, tcfg = _configs({})
    tp = params_from_numpy(_params(jcfg), "cpu", dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(1, 12, D)).astype(np.float32))
    whole = tmoe.moe_block(tp, x, tcfg, no_drop=True)
    parts = torch.cat([tmoe.moe_block(tp, x[:, i:i + 1], tcfg) for i in range(12)], dim=1)
    torch.testing.assert_close(whole, parts, atol=1e-6, rtol=0)
    capped = tmoe.moe_block(tp, x, tcfg)
    assert (capped - parts).abs().max() > 1e-3


def test_top_k_ties_pick_the_lower_index_like_jax():
    rng = np.random.default_rng(2)
    base = rng.integers(0, 4, size=(32, 12)).astype(np.float32) / 4   # many exact ties
    for k in (1, 2, 5, 12):
        ours = tmoe.top_k_lowest_first(torch.from_numpy(base), k).numpy()
        theirs = np.asarray(jax.lax.top_k(jnp.asarray(base), k)[1])
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tied_router_scores_pick_the_same_experts(dtype):
    """Router columns equal in threes: every token's probabilities tie
    exactly in groups of three, so top-2 must break a tie inside the best
    group; both packages take the lower expert index, hence the same
    experts (whose weights differ) and the same output."""
    jcfg, tcfg = _configs({})
    p = _params(jcfg, seed=3)
    r = p["router"]
    p["router"] = np.stack([r[:, 0]] * 3 + [r[:, 3]] * 3 + [r[:, 6]] * 2, axis=1)
    x = np.random.default_rng(4).normal(size=(3, 5, D)).astype(np.float32)
    tr = torch.from_numpy(p["router"])
    probs = torch.softmax(torch.from_numpy(x).reshape(-1, D) @ tr, dim=-1)
    assert (probs[:, 0] == probs[:, 1]).all() and (probs[:, 1] == probs[:, 2]).all()
    theirs, ours = _both(p, x, jcfg, tcfg, dtype, no_drop=True)
    if dtype == "float32":
        np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=0)
    else:
        _assert_bf16_close(ours, theirs)
    # which of the tied experts is picked matters: the same routing over
    # experts whose weights are reversed inside each tied group differs
    perm = [2, 1, 0, 5, 4, 3, 7, 6]
    flipped = dict(p, **{n: p[n][perm] for n in ("w_gate", "w_up", "w_down")})
    wp = params_from_numpy(flipped, "cpu", dtype=torch.float32)
    other = tmoe.moe_block(wp, torch.from_numpy(x), tcfg, no_drop=True).numpy()
    assert np.abs(other - ours).max() > 1e-3


def test_int8_mode_leaves_routed_experts_exact():
    """ODIN modes quantise only the shared experts' ``linear``: with no
    shared expert the int8 block equals the exact one bit for bit."""
    jcfg, tcfg = _configs({})
    tp = params_from_numpy(_params(jcfg), "cpu", dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 5, D)).astype(np.float32))
    exact = tmoe.moe_block(tp, x, tcfg)
    assert torch.equal(tmoe.moe_block(tp, x, tcfg, odin=OdinConfig(mode="int8")), exact)
    # with a shared expert, int8 mode does reach it
    jcfg, tcfg = _configs(dict(n_shared=1))
    tp = params_from_numpy(_params(jcfg), "cpu", dtype=torch.float32)
    assert not torch.equal(tmoe.moe_block(tp, x, tcfg, odin=OdinConfig(mode="int8")),
                           tmoe.moe_block(tp, x, tcfg))


# bf16: the port sums each token's k assignments in the reference's order
# and dtype (its segment_sum, bit for bit), and its expert products agree
# with the JAX einsums on all but a few elements; the silu differs: the
# reference's bf16 silu rounds sigmoid(g) before the multiply, PyTorch's
# rounds once (on 41 % of random bf16 inputs they part by an ulp).
# Measured over CASES: 24-59 % of the outputs part; the largest difference
# is 2^-6.85 of the output's largest magnitude (gelu_drops), 2^-7.7 to
# 2^-8.0 in the others (0.0156 at max |y| = 3.1 with a shared expert, whose
# sum with the routed output cancels, so an elementwise relative bound
# does not hold).  Bound: 2^-5 of the largest magnitude, 4x the worst.
BF16_NORMWISE = 2.0 ** -5


def _assert_bf16_close(ours, theirs):
    err = np.abs(ours - theirs).max()
    assert err <= BF16_NORMWISE * np.abs(theirs).max(), (err, np.abs(theirs).max())


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_difference_to_jax(case):
    c = CASES[case]
    jcfg, tcfg = _configs(c["cfg"])
    x = np.random.default_rng(len(case)).normal(size=(c.get("B", 2), c["S"], D)).astype(
        np.float32)
    theirs, ours = _both(_params(jcfg), x, jcfg, tcfg, "bfloat16", no_drop=c["no_drop"],
                         activation_kind=c.get("act", "swiglu"))
    _assert_bf16_close(ours, theirs)
