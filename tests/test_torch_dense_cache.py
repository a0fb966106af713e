"""The port's dense and ring-buffer KV caches, the Hymba LM and the static
loop, against the JAX package.

* ``attention`` over the four dense cache cases of the JAX package's
  ``_gqa_attention`` (scalar ``pos`` dense with ``dynamic_update_slice``'s
  start clamp, scalar ``pos`` ring, per-slot dense with rows past the cache
  dropped, per-slot ring past a wrap), float32 and int8 caches.  Inputs and
  weights are small multiples of powers of two and RoPE is off, so K and V
  are exact in both frameworks: the cache leaves must be equal, the outputs
  agree within the paged kernel's bound (3e-5).
* ``_ring_positions`` past a wrap, exactly.
* The hymba smoke ``lm.forward`` through a prefill and 3 decode steps on
  dense caches (the static loop's, a prompt longer than the ring included)
  and on serving caches whose global segment is the paged pool: logits
  within phi4's 1e-4.
* The static loop: the port's ``serve_static`` against the JAX package's
  ``make_prefill_step``/``make_decode_step`` on the same prompts (float32),
  and against the port's engine (``serve``), for phi4 and hymba."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from serving_harness import materialize

from repro.configs.base import AttnConfig as JAttnConfig
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.nn import attention as jattn
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import AttnConfig
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.models import registry as tregistry
from repro_torch.nn import attention as tattn

H, HKV, D, DM = 4, 2, 16, 32


def _exact(rng, shape, lo, hi, scale):
    """Small integers times a power of two: sums of them are exact in float32."""
    return (rng.integers(lo, hi + 1, size=shape) * scale).astype(np.float32)


# (name, window, cache rows, pos, S): pos a scalar or per-slot [B]
CASES = [
    ("scalar_dense", 0, 16, 5, 3),
    ("scalar_dense_start_clamped", 0, 16, 14, 4),
    ("scalar_ring_wrapped", 8, 8, 10, 3),
    ("scalar_ring_chunk_past_ring", 8, 8, 0, 12),
    ("slot_dense", 0, 16, [0, 5, 13], 3),
    ("slot_dense_rows_past_cache", 0, 16, [14, 2, 15], 4),
    ("slot_ring_wrapped", 8, 12, [3, 11, 25], 2),
]


@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("name,window,size,pos,S", CASES, ids=[c[0] for c in CASES])
def test_dense_cache_attention_matches_jax(name, window, size, pos, S, kv):
    rng = np.random.default_rng(len(name) + S)
    B = 3
    x = _exact(rng, (B, S, DM), -2, 2, 1 / 8)
    p = {"q": _exact(rng, (DM, H * D), -1, 1, 1 / 4),
         "k": _exact(rng, (DM, HKV * D), -1, 1, 1 / 4),
         "v": _exact(rng, (DM, HKV * D), -1, 1, 1 / 4),
         "o": _exact(rng, (H * D, DM), -1, 1, 1 / 16)}
    if kv == "int8":
        k0 = rng.integers(-127, 128, (B, size, HKV, D)).astype(np.int8)
        v0 = rng.integers(-127, 128, (B, size, HKV, D)).astype(np.int8)
    else:
        k0 = rng.normal(size=(B, size, HKV, D)).astype(np.float32)
        v0 = rng.normal(size=(B, size, HKV, D)).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    acfg = dict(kind="gqa", n_heads=H, n_kv_heads=HKV, d_head=D, window=window,
                rope="none")
    jo, jc = jax.jit(lambda p, x, c: jattn.attention(p, x, JAttnConfig(**acfg), cache=c))(
        {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x),
        {"k": jnp.asarray(k0), "v": jnp.asarray(v0), "pos": jnp.asarray(pos)})
    tcache = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy()),
              "pos": torch.from_numpy(pos.copy())}
    to, tc = tattn.attention({n: torch.from_numpy(a) for n, a in p.items()},
                             torch.from_numpy(x), AttnConfig(**acfg), cache=tcache)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=3e-5, rtol=0)
    for leaf in ("k", "v", "pos"):
        assert tc[leaf].dtype == getattr(torch, str(np.asarray(jc[leaf]).dtype))
        np.testing.assert_array_equal(tc[leaf].numpy(), np.asarray(jc[leaf]), err_msg=leaf)
    # written out of place: the caller's cache is left as it was
    for leaf, before in (("k", k0), ("v", v0), ("pos", pos)):
        np.testing.assert_array_equal(tcache[leaf].numpy(), before)


def test_ring_positions_match_jax():
    for size in (1, 8, 12):
        for nxt in (0, 1, 3, size, size + 1, 2 * size + 5, 100):
            ours = tattn._ring_positions(torch.tensor(nxt, dtype=torch.int32), size)
            theirs = jattn._ring_positions(jnp.int32(nxt), size)
            np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    nxt = np.array([[0], [5], [13], [40]], np.int32)
    np.testing.assert_array_equal(
        tattn._ring_positions(torch.from_numpy(nxt), 12).numpy(),
        np.asarray(jattn._ring_positions(jnp.asarray(nxt), 12)))


@pytest.fixture(scope="module")
def hymba():
    jcfg, jparams = materialize("hymba-1.5b")
    host = jax.tree.map(np.asarray, jparams)
    jcfg = jcfg.with_overrides(kv_dtype="float32")
    # one compile a shape, instead of the layer scans' compiles on every
    # op-by-op call
    jforward = jax.jit(lambda p, t, **kw: jlm.forward(p, t, jcfg, **kw))
    return {"jax": (jcfg, jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jparams)),
            "jforward": jforward,
            "torch": (tregistry.get_smoke("hymba-1.5b").with_overrides(kv_dtype="float32"),
                      params_from_numpy(host, "cpu", dtype=torch.float32))}


@pytest.mark.parametrize("prompt_len", [8, 12], ids=["within_ring", "past_ring"])
def test_hymba_forward_on_dense_caches(hymba, prompt_len):
    """The static loop's caches: a ring of exactly the window (8 rows), a
    scalar ``pos``; the 12-token prompt overwrites ring rows in one write."""
    (jcfg, jparams), (tcfg, tparams) = hymba["jax"], hymba["torch"]
    jforward = hymba["jforward"]
    B, max_len = 2, 32
    jc = jlm.init_caches(jcfg, B, max_len)
    tc = tlm.init_caches(tcfg, B, max_len)
    rng = np.random.default_rng(prompt_len)
    prompt = rng.integers(0, jcfg.vocab, size=(B, prompt_len)).astype(np.int32)
    jl, jc, _ = jforward(jparams, jnp.asarray(prompt), caches=jc)
    tl, tc, _ = tlm.forward(tparams, torch.from_numpy(prompt), tcfg, caches=tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    for step in range(3):
        tok = rng.integers(0, jcfg.vocab, size=(B, 1)).astype(np.int32)
        start = np.int32(prompt_len + step)
        jl, jc, _ = jforward(jparams, jnp.asarray(tok), caches=jc,
                             start_pos=jnp.asarray(start))
        tl, tc, _ = tlm.forward(tparams, torch.from_numpy(tok), tcfg, caches=tc,
                                start_pos=torch.tensor(start))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    for seg, jseg in zip(tc, jc):
        np.testing.assert_array_equal(seg["attn"]["pos"].numpy(),
                                      np.asarray(jseg["attn"]["pos"]))
        np.testing.assert_allclose(seg["ssm"]["h"].numpy(), np.asarray(jseg["ssm"]["h"]),
                                   atol=1e-4)


def test_hymba_forward_on_serving_caches(hymba):
    """Serving caches: per-slot rings with 8 rows of headroom, the global
    segment on the paged pool (its decode through ``paged_attention``)."""
    (jcfg, jparams), (tcfg, tparams) = hymba["jax"], hymba["torch"]
    jforward = hymba["jforward"]
    B, bs, n_blocks, max_len = 2, 8, 8, 32
    kw = dict(window_headroom=8, round_to=bs, block_size=bs, n_blocks=n_blocks)
    jc = jsteps.init_serving_caches(jcfg, B, max_len, **kw)
    tc = tsteps.init_serving_caches(tcfg, B, max_len, device="cpu", **kw)
    assert set(tc[1]["attn"]) == {"k_pool", "v_pool", "pos"}
    assert tuple(tc[0]["attn"]["k"].shape) == np.asarray(jc[0]["attn"]["k"]).shape
    tables = np.arange(B * 4, dtype=np.int32).reshape(B, 4)[:, ::-1].copy()
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, jcfg.vocab, size=(B, 12)).astype(np.int32)
    jl, jc, _ = jforward(jparams, jnp.asarray(prompt), caches=jc,
                         tables=jnp.asarray(tables))
    tl, tc, _ = tlm.forward(tparams, torch.from_numpy(prompt), tcfg, caches=tc,
                            tables=torch.from_numpy(tables))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    for step in range(3):
        tok = rng.integers(0, jcfg.vocab, size=(B, 1)).astype(np.int32)
        pos = np.full((B, 1), 12 + step, np.int32)
        jl, jc, _ = jforward(jparams, jnp.asarray(tok), caches=jc,
                             start_pos=jnp.asarray(pos), tables=jnp.asarray(tables))
        tl, tc, _ = tlm.forward(tparams, torch.from_numpy(tok), tcfg, caches=tc,
                                start_pos=torch.from_numpy(pos),
                                tables=torch.from_numpy(tables))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    for seg, jseg in zip(tc, jc):
        np.testing.assert_array_equal(seg["attn"]["pos"].numpy(),
                                      np.asarray(jseg["attn"]["pos"]))


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "hymba-1.5b"])
def test_serve_static_matches_jax_static_loop(arch):
    jcfg, jparams = materialize(arch)
    jcfg = jcfg.with_overrides(kv_dtype="float32")
    jp32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jparams)
    tcfg = tregistry.get_smoke(arch).with_overrides(kv_dtype="float32")
    tp32 = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", dtype=torch.float32)
    batch, prompt_len, gen = 3, 8, 8
    ours, _ = tserve.serve_static(tcfg, batch=batch, prompt_len=prompt_len, gen=gen,
                                  params=tp32, device="cpu", verbose=False)
    prompts = np.stack([r.prompt for r in tserve._batch_requests(tcfg, batch, prompt_len,
                                                                 gen, 0)])
    prefill = jax.jit(jsteps.make_prefill_step(jcfg, max_len=prompt_len + gen))
    decode = jax.jit(jsteps.make_decode_step(jcfg))
    last, caches = prefill(jp32, {"tokens": jnp.asarray(prompts)})
    tok = jnp.argmax(last, axis=-1).astype(jnp.int32)[:, None]
    outs = []
    for _ in range(gen):
        outs.append(tok)
        tok, caches = decode(jp32, caches, tok)
    np.testing.assert_array_equal(ours, np.asarray(jnp.concatenate(outs, axis=-1)))


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "hymba-1.5b"])
def test_engine_serve_matches_serve_static(arch):
    """Prompt 8 stays inside hymba's smoke window (8): past it the static
    loop's one-shot prefill through a window-sized ring is lossy (as the JAX
    package's is), while the engine's ring has headroom and is exact."""
    cfg = tregistry.get_smoke(arch)
    kw = dict(batch=3, prompt_len=8, gen=8, seed=0, verbose=False, device="cpu")
    engine, _ = tserve.serve(cfg, **kw)
    static, _ = tserve.serve_static(cfg, **kw)
    np.testing.assert_array_equal(engine, static)


def test_slot_prefill_reset_restores_the_initial_state(hymba):
    """A reset at ``start > 0`` (a mid-sequence admission) restores a slot's
    per-slot leaves to their initial state: zero ring rows and SSM state,
    ``pos = start``; the slot's old contents (random here) leave no trace,
    and the other slots are untouched."""
    (jcfg, jparams), (tcfg, tparams) = hymba["jax"], hymba["torch"]
    B, bs, max_len, start = 3, 8, 32, 3
    kw = dict(window_headroom=8, round_to=bs, block_size=bs)
    jc = jsteps.init_serving_caches(jcfg, B, max_len, n_blocks=8, **kw)
    rng = np.random.default_rng(7)
    host = [{blk: {n: (rng.integers(0, 9, a.shape).astype(np.int32) if n == "pos"
                       else rng.normal(size=a.shape).astype(np.float32))
                   for n, a in leaves.items()}
             for blk, leaves in seg.items()} for seg in jax.tree.map(np.asarray, jc)]
    jc = jax.tree.map(jnp.asarray, host)
    tc = [{blk: {n: torch.from_numpy(a.copy()) for n, a in leaves.items()}
           for blk, leaves in seg.items()} for seg in host]
    tables = np.arange(B * 4, dtype=np.int32).reshape(B, 4)
    tokens = rng.integers(0, jcfg.vocab, size=(1, 4)).astype(np.int32)
    jstep = jax.jit(jsteps.make_slot_prefill_step(jcfg, max_len, paged=True, **kw))
    jl, jc = jstep(jparams, jc, jnp.asarray(tokens), 1, start, True, jnp.asarray(tables))
    tstep = tsteps.make_slot_prefill_step(tcfg, max_len, paged=True, **kw)
    tl, tc = tstep(tparams, tc, torch.from_numpy(tokens), 1, start, True,
                   torch.from_numpy(tables))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    for seg, jseg, hseg in zip(tc, jc, host):
        for blk in seg:
            for n, t in seg[blk].items():
                theirs = np.asarray(jseg[blk][n])
                if n in ("k_pool", "v_pool"):
                    continue                    # the rows written, in place
                np.testing.assert_allclose(t.numpy(), theirs, atol=1e-5, err_msg=n)
                np.testing.assert_array_equal(t.numpy()[:, [0, 2]], hseg[blk][n][:, [0, 2]])
