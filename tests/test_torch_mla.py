"""DeepSeek's multi-head latent attention (MLA) in the port, against the JAX
package's ``nn/attention.py``.

Both packages run ``attention`` on the same numpy-seeded inputs and weights
at the deepseek smoke widths (4 heads, ranks 32/32, qk 16 + 8, v 16), in
float32, outputs within 1e-5:

* ``attn_spec`` with and without ``q_lora_rank``: keys, shapes, dtypes
  (``kv_norm`` and ``q_norm`` float32);
* no cache (S = 12), both branches;
* a scalar-``pos`` prefill into a dense latent cache, then 4 decode steps;
* the latent cache's write cases: a scalar ``pos`` (with
  ``dynamic_update_slice``'s start clamp), a per-slot ``pos`` with unequal
  lengths, a tile whose rows run past ``max_len`` (dropped, as JAX drops an
  out-of-bounds scatter), in float32 and int8.  The cache leaves must equal
  JAX's bit for bit.  XLA and PyTorch round ``rsqrt`` and RoPE's cos/sin
  differently on the CPU, so these cases feed a latent whose rows have a
  mean square of exactly 256 (``rsqrt`` exact) and a zero RoPE input (the
  written ``k_rope`` rows exactly 0, over a random cache that shows where
  they land); the two cases above hold the RoPE path at 1e-5;
* the JAX suite's int8 case (``tests/test_attention.py``
  ``test_int8_kv_cache_parity[mla]``): bf16 tokens decoded one by one
  against an int8 latent cache stay within 0.15 of exact attention, and
  every int8 cache leaf equals JAX's;
* ODIN's int8 mode on the projections, JAX run op by op
  (``jax.disable_jit``: under ``jit`` XLA divides a scale by 255 as a
  multiply by a rounded reciprocal);
* the compressed cache's shape (``tests/test_attention.py
  test_mla_cache_is_compressed``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.base import AttnConfig as JAttnConfig
from repro.core.odin_linear import OdinConfig as JOdinConfig
from repro.nn import attention as jattn
from repro.nn import module as jmodule
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import AttnConfig
from repro_torch.core.odin_linear import OdinConfig
from repro_torch.nn import attention as tattn
from repro_torch.tree import leaves_with_path

DM = 64
MLA = dict(kind="mla", n_heads=4, n_kv_heads=4, d_head=16, q_lora_rank=32,
           kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
R, ROPE = MLA["kv_lora_rank"], MLA["qk_rope_dim"]
TOL = 1e-5


def _cfgs(q_lora=True):
    kw = dict(MLA, q_lora_rank=MLA["q_lora_rank"] if q_lora else 0)
    return JAttnConfig(**kw), AttnConfig(**kw)


def _weights(rng, cfg, exact_latent=False):
    """Weights of ``cfg``'s spec, N(0, 1/fan_in), norms N(1, 0.1).  With
    ``exact_latent`` the latent columns of ``kv_down`` are 16·I (so an
    input of ±1 gives latent rows of ±16, mean square 256), its RoPE
    columns 0, and ``kv_norm`` multiples of 1/32."""
    out = {}
    for path, _, s in leaves_with_path(tattn.attn_spec(cfg, DM)):
        name = path[2:-2]
        if s.dtype == torch.float32:
            out[name] = (1 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        else:
            out[name] = (rng.normal(size=s.shape) / np.sqrt(s.shape[0])).astype(np.float32)
    if exact_latent:
        out["kv_down"] = np.zeros((DM, R + ROPE), np.float32)
        out["kv_down"][:R, :R] = 16 * np.eye(R, dtype=np.float32)
        out["kv_norm"] = (rng.integers(-64, 65, size=R) / 32).astype(np.float32)
    return out


def _x(rng, shape, exact_latent=False):
    if exact_latent:
        return rng.choice(np.array([-1.0, 1.0], np.float32), size=shape)
    return (rng.normal(size=shape) * 0.5).astype(np.float32)


def _run_both(p, x, cache, q_lora=True, jit=True, jodin=None, todin=None):
    """(port output, port cache, JAX output, JAX cache) as numpy, and the
    port's input cache tensors (to check it was left as it was)."""
    jcfg, tcfg = _cfgs(q_lora)
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    jc = None if cache is None else {n: jnp.asarray(a) for n, a in cache.items()}

    def jfn(jp, x, jc):
        return jattn.attention(jp, x, jcfg, cache=jc, odin=jodin)

    jo, jc2 = (jax.jit(jfn) if jit else jfn)(jp, jnp.asarray(x), jc)
    tc = None if cache is None else {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    to, tc2 = tattn.attention({n: torch.from_numpy(a) for n, a in p.items()},
                              torch.from_numpy(x), tcfg, cache=tc, odin=todin)
    as_np = lambda c: None if c is None else {n: np.asarray(a) for n, a in c.items()}
    return (to.numpy(), as_np({n: t.numpy() for n, t in tc2.items()} if tc2 else None),
            np.asarray(jo), as_np(jc2), tc)


@pytest.mark.parametrize("q_lora", [True, False], ids=["q_lora", "no_q_lora"])
def test_attn_spec_matches_jax(q_lora):
    jcfg, tcfg = _cfgs(q_lora)
    ours = {p: s for p, _, s in leaves_with_path(tattn.attn_spec(tcfg, DM))}
    theirs = {p: s for p, _, s in leaves_with_path(jattn.attn_spec(jcfg, DM))}
    assert ours.keys() == theirs.keys()
    assert ("['q_down']" in ours) == q_lora and ("['q']" in ours) != q_lora
    for k, s in ours.items():
        assert s.shape == tuple(theirs[k].shape), k
        assert str(s.dtype).split(".")[-1] == np.dtype(theirs[k].dtype).name, k
        assert s.logical_axes == tuple(theirs[k].logical_axes), k
    assert ours["['kv_norm']"].dtype == torch.float32
    if q_lora:
        assert ours["['q_norm']"].dtype == torch.float32


@pytest.mark.parametrize("q_lora", [True, False], ids=["q_lora", "no_q_lora"])
def test_no_cache_matches_jax(q_lora):
    rng = np.random.default_rng(1 + q_lora)
    p = _weights(rng, _cfgs(q_lora)[1])
    to, _, jo, _, _ = _run_both(p, _x(rng, (2, 12, DM)), None, q_lora)
    np.testing.assert_allclose(to, jo, atol=TOL, rtol=0)


def test_scalar_prefill_then_decode_matches_jax():
    """An 8-token prefill into a fresh 16-row latent cache, then 4 decode
    steps; each step's output within 1e-5, the caches within float32
    rounding."""
    rng = np.random.default_rng(3)
    p = _weights(rng, _cfgs()[1])
    B, size = 2, 16
    cache = {"c_kv": np.zeros((B, size, R), np.float32),
             "k_rope": np.zeros((B, size, ROPE), np.float32),
             "pos": np.zeros((), np.int32)}
    tcache = dict(cache)
    for S in (8, 1, 1, 1, 1):
        x = _x(rng, (B, S, DM))
        to, tc, jo, jc, _ = _run_both(p, x, tcache)
        np.testing.assert_allclose(to, jo, atol=TOL, rtol=0)
        for leaf in ("c_kv", "k_rope"):
            np.testing.assert_allclose(tc[leaf], jc[leaf], atol=TOL, rtol=0, err_msg=leaf)
        np.testing.assert_array_equal(tc["pos"], jc["pos"])
        tcache = jc                             # both continue from JAX's cache
    assert int(jc["pos"]) == 12


# (name, cache rows, pos, S): pos a scalar or per-slot [B]
WRITE_CASES = [
    ("scalar", 16, 5, 3),
    ("scalar_start_clamped", 16, 14, 4),
    ("slot_unequal_lengths", 16, [0, 5, 11], 3),
    ("slot_rows_past_max_len", 16, [14, 2, 15], 5),
]


@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("name,size,pos,S", WRITE_CASES, ids=[c[0] for c in WRITE_CASES])
def test_latent_cache_writes_match_jax(name, size, pos, S, kv):
    rng = np.random.default_rng(len(name) + S)
    B = 3
    p = _weights(rng, _cfgs()[1], exact_latent=True)
    x = _x(rng, (B, S, DM), exact_latent=True)
    if kv == "int8":
        c0 = rng.integers(-127, 128, (B, size, R)).astype(np.int8)
        r0 = rng.integers(-127, 128, (B, size, ROPE)).astype(np.int8)
    else:
        c0 = rng.normal(size=(B, size, R)).astype(np.float32)
        r0 = rng.normal(size=(B, size, ROPE)).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    cache = {"c_kv": c0, "k_rope": r0, "pos": pos}
    to, tc, jo, jc, tcache = _run_both(p, x, cache)
    np.testing.assert_allclose(to, jo, atol=TOL, rtol=0)
    for leaf in ("c_kv", "k_rope", "pos"):
        assert tc[leaf].dtype == jc[leaf].dtype, leaf
        np.testing.assert_array_equal(tc[leaf], jc[leaf], err_msg=leaf)
    # the new rows landed: each slot's written c_kv rows differ from c0
    written = (tc["c_kv"] != c0).any(-1)
    assert written.any() and not written.all()
    # written out of place: the caller's cache is left as it was
    for leaf, before in cache.items():
        np.testing.assert_array_equal(tcache[leaf].numpy(), before)


def test_int8_latent_cache_parity():
    """The JAX suite's int8 case on both packages: its spec materialised by
    the JAX package and carried across; 12 bf16 tokens decoded one by one
    against an int8 latent cache stay within 0.15 of exact attention, and
    the int8 cache leaves and outputs equal JAX's."""
    jcfg, tcfg = _cfgs()
    params = jmodule.materialize(jattn.attn_spec(jcfg, DM), jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    B, S = 2, 12
    x = (np.random.default_rng(7).normal(size=(B, S, DM)) * 1.5).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jfull, _ = jattn.attention(params, jx, jcfg)
    tfull, _ = tattn.attention(tparams, tx, tcfg)
    jc = jattn.init_cache(jcfg, B, max_len=S, dtype=jnp.int8)
    tc = tattn.init_cache(tcfg, B, max_len=S, dtype=torch.int8)
    assert all(t.dtype == torch.int8 for k, t in tc.items() if k != "pos")
    jstep = jax.jit(lambda p, x, c: jattn.attention(p, x, jcfg, cache=c))
    jouts, touts = [], []
    for t in range(S):
        o, jc = jstep(params, jx[:, t:t + 1], jc)
        jouts.append(o)
        o, tc = tattn.attention(tparams, tx[:, t:t + 1], tcfg, cache=tc)
        touts.append(o)
        for leaf in ("c_kv", "k_rope", "pos"):
            np.testing.assert_array_equal(tc[leaf].numpy(), np.asarray(jc[leaf]),
                                          err_msg=f"step {t} {leaf}")
    tinc = torch.cat(touts, 1).float().numpy()
    jinc = np.asarray(jnp.concatenate(jouts, 1), np.float32)
    assert np.abs(tfull.float().numpy() - tinc).max() < 0.15
    assert np.abs(np.asarray(jfull, np.float32) - jinc).max() < 0.15
    # bf16 outputs of the same int8 cache: one bf16 rounding apart at most
    np.testing.assert_allclose(tinc, jinc, atol=1e-2, rtol=2.0 ** -7)


def test_odin_int8_projections_match_eager_jax():
    """ODIN's int8 mode on every projection (q_down, q_up, kv_down, k_up,
    v_up, o), a scalar-pos prefill into a latent cache; JAX op by op."""
    rng = np.random.default_rng(11)
    p = _weights(rng, _cfgs()[1])
    B, S, size = 2, 6, 8
    cache = {"c_kv": np.zeros((B, size, R), np.float32),
             "k_rope": np.zeros((B, size, ROPE), np.float32),
             "pos": np.zeros((), np.int32)}
    x = _x(rng, (B, S, DM))
    with jax.disable_jit():
        to, tc, jo, jc, _ = _run_both(p, x, cache, jit=False,
                                      jodin=JOdinConfig(mode="int8"),
                                      todin=OdinConfig(mode="int8"))
    np.testing.assert_allclose(to, jo, atol=TOL, rtol=0)
    for leaf in ("c_kv", "k_rope"):
        np.testing.assert_allclose(tc[leaf], jc[leaf], atol=TOL, rtol=0, err_msg=leaf)
    # int8 really ran: the exact projections give another output
    exact, _, _, _, _ = _run_both(p, x, cache)
    assert np.abs(exact - to).max() > 1e-4


def test_mla_cache_is_compressed():
    """The latent cache holds r ≪ H·(D_nope + D_v) numbers a token."""
    kw = dict(kind="mla", n_heads=8, n_kv_heads=8, d_head=128, kv_lora_rank=64,
              qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32)
    cache = tattn.init_cache(AttnConfig(**kw), batch=2, max_len=100)
    jcache = jattn.init_cache(JAttnConfig(**kw), batch=2, max_len=100)
    assert set(cache) == set(jcache) == {"c_kv", "k_rope", "pos"}
    for k in cache:
        assert tuple(cache[k].shape) == jcache[k].shape
        assert cache[k].dtype == torch.bfloat16 or k == "pos"
    assert tuple(cache["c_kv"].shape) == (2, 100, 64)
    full_kv = 2 * 100 * 8 * (32 + 32)
    assert cache["c_kv"].numel() + cache["k_rope"].numel() < full_kv / 4
