"""The CUDA paged-attention kernel's algorithm (the page axis split into
ranges, a partial (m, l, acc) per range, then the combine formula), run in
plain PyTorch by ``paged_attn_split_ref``, against the plain version
``paged_attn_ref`` on the cases of tests/test_torch_paged_attn.py, and on
two of them against the JAX package's Pallas kernel in interpret mode.
Bounds are the JAX suite's for float32: atol 3e-5, rtol 1e-4; zero-length
slots and fully masked rows are exactly 0.  Also the host-side split plan:
it covers every page once and reads nothing but shapes."""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.paged_attn import paged_attention as jax_paged_attention
from repro_torch.kernels.paged_attn import ops
from repro_torch.kernels.paged_attn.ref import paged_attn_ref, paged_attn_split_ref
from repro_torch.nn.attention import KV_SCALE
from test_torch_paged_attn import B, CASES, D, HKV, P, _inputs

ATOL, RTOL = 3e-5, 1e-4


def _packed(G, Q, window, int8, special, seed=None):
    seed = G * 100 + Q * 10 + window if seed is None else seed
    q, kp, vp, tables, lengths = _inputs(seed, G, Q, int8, special)
    qt = q.reshape(B, Q, HKV, G, D).transpose(0, 2, 1, 3, 4).reshape(B, HKV, Q * G, D)
    return [torch.from_numpy(x) for x in (qt, kp, vp, tables, lengths)]


@pytest.mark.parametrize("pages_per_split", [1, 2, 3, P])
@pytest.mark.parametrize("G,Q,window,int8,special", CASES)
def test_split_matches_plain(G, Q, window, int8, special, pages_per_split):
    qt, kp, vp, tables, lengths = _packed(G, Q, window, int8, special)
    kw = dict(window=window, kv_scale=KV_SCALE if int8 else None, q_len=Q)
    ref = paged_attn_ref(qt, kp, vp, tables, lengths, **kw).numpy()
    out = paged_attn_split_ref(qt, kp, vp, tables, lengths,
                               pages_per_split=pages_per_split, **kw).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    if special == "zero_len":
        assert np.all(out[0] == 0.0)
    if special == "masked_rows":
        assert np.all(out[1, :, :(Q - 1) * G] == 0.0)


@pytest.mark.parametrize("case", [CASES[1], CASES[5]])
def test_split_matches_jax_kernel(case):
    """A window case (float32 pool) and a window verify tile on an int8
    pool, two pages a split, against the Pallas kernel in interpret mode."""
    G, Q, window, int8, special = case
    q, kp, vp, tables, lengths = _inputs(G * 100 + Q * 10 + window, G, Q, int8, special)
    kv_scale = KV_SCALE if int8 else None
    qq = q[:, 0] if Q == 1 else q
    theirs = np.asarray(jax_paged_attention(
        jnp.asarray(qq), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(lengths), window=window, kv_scale=kv_scale, interpret=True))
    qt, kpt, vpt, tt, lt = _packed(G, Q, window, int8, special)
    ours = paged_attn_split_ref(qt, kpt, vpt, tt, lt, pages_per_split=2, window=window,
                                kv_scale=kv_scale, q_len=Q)
    ours = ours.reshape(B, HKV, Q, G, D).permute(0, 2, 1, 3, 4).reshape(qq.shape).numpy()
    np.testing.assert_allclose(ours, theirs, atol=ATOL, rtol=RTOL)


def test_every_split_of_a_slot_empty():
    """Slot 0 has length 0 and slot 2's window leaves its first splits
    empty: one page a split, every partial of slot 0 is (NEG_INF, 0, 0),
    and its rows stay exactly 0 with no NaN."""
    qt, kp, vp, tables, lengths = _packed(3, 1, 5, False, "zero_len", seed=7)
    lengths[2] = P * 8
    for window in (0, 5):
        out = paged_attn_split_ref(qt, kp, vp, tables, lengths, pages_per_split=1,
                                   window=window)
        ref = paged_attn_ref(qt, kp, vp, tables, lengths, window=window)
        assert torch.isfinite(out).all() and torch.all(out[0] == 0.0)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("B_,Hkv,P_,bs,n_sm", [
    (8, 8, 64, 16, 132), (1, 8, 64, 16, 132), (64, 8, 16, 16, 132), (3, 2, 5, 8, 132),
    (8, 8, 1, 16, 132), (2, 1, 7, 1, 4), (1, 1, 1000, 16, 132),
])
def test_split_plan_covers_every_page_once(B_, Hkv, P_, bs, n_sm):
    pages, n_splits = ops.split_plan(B_, Hkv, P_, bs, n_sm)
    covered = [p for s in range(n_splits)
               for p in range(s * pages, min(P_, (s + 1) * pages))]
    assert covered == list(range(P_))
    assert (n_splits == 1) == (P_ <= pages)
    assert (n_splits - 1) * pages < P_                  # no split starts past P
    assert pages * bs >= 32 or pages == P_              # at least 32 keys a split


def test_split_plan_at_the_serving_shapes():
    """phi4-mini's decode: B=8 slots, 8 kv-heads, 64 pages of 16 keys on
    132 SMs gives 512 CTAs of 8 pages; one long slot 256 CTAs; 64 slots
    fill the card without a split.  The plan sees shapes only."""
    assert ops.split_plan(8, 8, 64, 16, 132) == (8, 8)
    assert ops.split_plan(1, 8, 64, 16, 132) == (2, 32)
    assert ops.split_plan(64, 8, 16, 16, 132) == (16, 1)
    params = inspect.signature(ops.split_plan).parameters
    assert list(params) == ["B", "Hkv", "P", "bs", "n_sm"]


@pytest.mark.parametrize("QG,D,bs,elt,pps,rt,pages", [
    (3, 128, 16, 2, 8, 3, 4), (9, 128, 16, 2, 8, 3, 4), (9, 64, 16, 1, 8, 3, 8),
    (8, 64, 64, 4, 1, 4, 1), (1, 128, 64, 4, 4, 1, 1), (3, 128, 16, 2, 2, 3, 2),
    (4, 128, 16, 2, 8, 4, 4), (6, 128, 16, 2, 8, 3, 4),
])
def test_launch_plan_fits_the_card(QG, D, bs, elt, pps, rt, pages):
    plan = ops.launch_plan(QG, D, bs, elt, pps)
    assert (plan["rt"], plan["pages_per_stage"]) == (rt, pages)
    assert 1 <= plan["rt"] <= 4                         # query tile + acc in registers
    assert plan["row_chunks"] * plan["rt"] >= QG > (plan["row_chunks"] - 1) * plan["rt"]
    assert plan["smem"] <= ops._MAX_SMEM
