"""musicgen-medium smoke (2 layers, 4 codebooks) through the port's LM and
ServingEngine, against the JAX package.

Tokens are frames of K = 4 EnCodec codebooks: prompts ``[K, S]``, the LM's
input ``[B, K, S]`` (the K embeddings of a frame summed) and its logits
``[B, S, K, V]`` (K heads); every engine token is a frame ``[K]``.  Weights
are the JAX package's ``materialize`` of the smoke config, carried across
by the bridge in float32; both engines run float32 KV pools.

* The bridge carries ``embed [K, V, d]`` and ``lm_head [K, d, V]``;
  ``count_params`` and ``model_flops`` equal the JAX package's (1,384,269,312
  parameters at the published config).
* ``lm.forward`` on ``[2, 4, 13]`` tokens: logits ``[2, 13, 4, 64]`` within
  1e-5 of the JAX forward, with no cache and through a prefill and 3 decode
  steps on serving caches.
* Engine greedy streams equal the JAX engine's on ``mixed_spec()`` with the
  defaults (mixed dispatch and prefix sharing on), with mixed dispatch off,
  at horizon 4, under swap and under recompute pressure, and on
  ``_shared_spec`` with prefix sharing on and off (hit tokens > 0); the
  static loop equals the engine and the JAX static loop; the front door's
  streams equal ``engine.run``'s; speculation is refused.
"""
import asyncio

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from serving_harness import materialize, mixed_spec, run_workload, token_streams
from test_frontdoor import _collect
from test_torch_engine import run_port

from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.models import registry as jregistry
from repro.nn import module as jmodule
from repro_torch.bridge import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.models import registry as tregistry
from repro_torch.nn import module as tmodule
from repro_torch.serving import FrontDoor, ServingEngine, make_requests
from repro_torch.tree import leaves_with_path

ARCH = "musicgen-medium"
K = 4
TOL = 1e-5
SHARED = mixed_spec(n_requests=6, shared_prefix=16)
# the engine knobs of each case (both packages run the same ones)
CASES = {
    "defaults": {},
    "no_mixed": {"mixed": False},
    "horizon4": {"horizon": 4},
    "swap_pressure": {"n_blocks": 8, "swap_blocks": 32},
    "recompute_pressure": {"n_blocks": 8, "swap_blocks": 0},
    "shared_on": {"spec": SHARED, "max_len": 64, "prefix_sharing": True},
    "shared_off": {"spec": SHARED, "max_len": 64, "prefix_sharing": False},
}
# each case's JAX run: the JAX engine's own streams are invariant to these
# knobs (its test_serving.py holds them), so one JAX run covers several
JAX_OF = {"defaults": "defaults", "no_mixed": "defaults", "horizon4": "defaults",
          "swap_pressure": "defaults", "recompute_pressure": "defaults",
          "shared_on": "shared_on", "shared_off": "shared_on"}


@pytest.fixture(scope="module")
def models():
    jcfg, jparams = materialize(ARCH)
    host = jax.tree.map(np.asarray, jparams)
    tcfg = tregistry.get_smoke(ARCH)
    return {"host": host,
            "jax32": (jcfg.with_overrides(kv_dtype="float32"),
                      jax.tree.map(lambda a: a.astype(np.float32), jparams)),
            "torch32": (tcfg.with_overrides(kv_dtype="float32"),
                        params_from_numpy(host, "cpu", dtype=torch.float32))}


@pytest.fixture(scope="module")
def runs(models):
    """Memoised engine runs: (package, case) → (streams, summary)."""
    cache = {}

    def get(pkg, case):
        if (pkg, case) not in cache:
            if pkg == "torch":
                cache[pkg, case] = run_port(*models["torch32"], **CASES[case])[:2]
            else:
                cache[pkg, case] = run_workload(*models["jax32"], **CASES[case])
        return cache[pkg, case]

    return get


def test_bridge_carries_the_codebook_leaves(models):
    """Every leaf crosses bit for bit; the embedding and the head carry the
    codebook axis in front."""
    tcfg = tregistry.get_smoke(ARCH)
    ours = {p: t for p, _, t in leaves_with_path(params_from_numpy(models["host"], "cpu"))}
    theirs = {p: a for p, _, a in leaves_with_path(models["host"])}
    spec = {p: s for p, _, s in leaves_with_path(tlm.param_spec(tcfg))}
    assert ours.keys() == theirs.keys() == spec.keys()
    for p, a in theirs.items():
        assert tuple(ours[p].shape) == a.shape == spec[p].shape, p
        assert ours[p].dtype == spec[p].dtype, p
        if a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(
                ours[p].view(torch.int16).numpy().view(np.uint16), a.view(np.uint16))
        else:
            np.testing.assert_array_equal(ours[p].numpy(), a)
    assert spec["['embed']"].shape == (K, tcfg.vocab, tcfg.d_model)
    assert spec["['lm_head']"].shape == (K, tcfg.d_model, tcfg.vocab)


@pytest.mark.parametrize("which", ["get_smoke", "get_config"])
def test_counts_equal_jax(which):
    ours, theirs = getattr(tregistry, which)(ARCH), getattr(jregistry, which)(ARCH)
    n = tmodule.count_params(tlm.param_spec(ours))
    assert n == jmodule.count_params(jlm.param_spec(theirs))
    for train in (True, False):
        assert tlm.model_flops(ours, 7, train=train) == jlm.model_flops(theirs, 7,
                                                                        train=train)
    if which == "get_config":
        assert n == 1_384_269_312


@pytest.mark.parametrize("layout", ["no_cache", "serving"])
def test_forward_matches_jax(models, layout):
    """``[2, 4, 13]`` tokens → logits ``[2, 13, 4, 64]`` within 1e-5 of the
    JAX forward; on serving caches, then 3 decode frames ``[2, 4, 1]``."""
    jcfg, jparams = models["jax32"]
    tcfg, tparams = models["torch32"]
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, tcfg.vocab, size=(2, K, 13)).astype(np.int32)
    if layout == "no_cache":
        jl = np.asarray(jlm.forward(jparams, jnp.asarray(tokens), jcfg)[0])
        tl = tlm.forward(tparams, torch.from_numpy(tokens), tcfg)[0].numpy()
        assert tl.shape == (2, 13, K, tcfg.vocab)
        np.testing.assert_allclose(tl, jl, atol=TOL, rtol=0)
        return
    jc = jsteps.init_serving_caches(jcfg, 2, 32)
    tc = tsteps.init_serving_caches(tcfg, 2, 32, device="cpu")
    jforward = jax.jit(lambda p, t, c, s: jlm.forward(p, t, jcfg, caches=c, start_pos=s))
    jl, jc, _ = jforward(jparams, jnp.asarray(tokens), jc, None)
    tl, tc, _ = tlm.forward(tparams, torch.from_numpy(tokens), tcfg, caches=tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    for step in range(3):
        frame = rng.integers(0, tcfg.vocab, size=(2, K, 1)).astype(np.int32)
        start = np.full((2, 1), 13 + step, np.int32)
        jl, jc, _ = jforward(jparams, jnp.asarray(frame), jc, jnp.asarray(start))
        tl, tc, _ = tlm.forward(tparams, torch.from_numpy(frame), tcfg, caches=tc,
                                start_pos=torch.from_numpy(start))
        assert tuple(tl.shape) == (2, 1, K, tcfg.vocab)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_streams_equal_jax_engine(runs, case):
    ours, summary = runs("torch", case)
    theirs, jsummary = runs("jax", JAX_OF[case])
    assert ours == theirs
    assert all(len(t) == K for s in ours.values() for t in s)
    assert summary["generated_tokens"] == jsummary["generated_tokens"]
    assert summary["kv_cache_bytes"] > 0
    if JAX_OF[case] == case:
        assert summary["kv_cache_bytes"] == jsummary["kv_cache_bytes"]
        assert summary["mixed"] == jsummary["mixed"]
        assert summary["prefix"] == jsummary["prefix"]
    if case in ("defaults", "shared_on", "shared_off"):
        assert summary["mixed"]["dispatches"] > 0
    if case == "no_mixed":
        assert summary["mixed"]["dispatches"] == 0
    if case == "horizon4":
        assert summary["decode_dispatches"] < summary["decode_steps"]
    if case == "swap_pressure":
        assert summary["preemptions"]["swap"] > 0
    if case == "recompute_pressure":
        assert summary["preemptions"]["recompute"] > 0
    if case == "shared_on":
        off = runs("torch", "shared_off")[1]
        assert summary["prefix"]["hit_tokens"] > 0 == off["prefix"]["hit_tokens"]
        assert summary["prefill_tokens"] < off["prefill_tokens"]


def _jax_static_loop(cfg, params, prompts, gen):
    prefill = jax.jit(jsteps.make_prefill_step(cfg, max_len=prompts.shape[-1] + gen))
    decode = jax.jit(jsteps.make_decode_step(cfg))
    last, caches = prefill(params, {"tokens": jnp.asarray(prompts)})
    tok = jnp.argmax(last, axis=-1).astype(jnp.int32)[..., None]
    outs = []
    for _ in range(gen):
        outs.append(tok)
        tok, caches = decode(params, caches, tok)
    return np.asarray(jnp.concatenate(outs, axis=-1))


def test_static_loop_equals_engine_and_jax(models):
    """``serve_static`` (``[B, K, gen]`` frames) equals ``serve`` on the same
    prompts and the JAX static loop on them."""
    tcfg, tparams = models["torch32"]
    batch, prompt_len, gen = 3, 8, 6
    static, _ = tserve.serve_static(tcfg, batch=batch, prompt_len=prompt_len, gen=gen,
                                    params=tparams, device="cpu", verbose=False)
    engine, _ = tserve.serve(tcfg, batch=batch, prompt_len=prompt_len, gen=gen,
                             params=tparams, device="cpu", verbose=False)
    assert static.shape == (batch, K, gen)
    np.testing.assert_array_equal(static, engine)
    prompts = np.stack([r.prompt for r in tserve._batch_requests(
        tcfg, batch, prompt_len, gen, 0)])
    assert prompts.shape == (batch, K, prompt_len)
    np.testing.assert_array_equal(static, _jax_static_loop(*models["jax32"], prompts, gen))


def test_front_door_streams_equal_engine_run(models):
    cfg, params = models["torch32"]
    spec = mixed_spec(3)

    def engine():
        return ServingEngine(cfg, slots=3, max_len=48, block_size=8, params=params,
                             device="cpu")

    ref = make_requests(cfg, spec, seed=9)
    engine().run(ref)

    async def main(reqs):
        fd = FrontDoor(engine(), max_queue=8)
        await fd.start()
        outs = await asyncio.gather(*[_collect(fd.submit(r)) for r in reqs])
        await fd.aclose()
        return outs

    reqs = make_requests(cfg, spec, seed=9)
    outs = asyncio.run(main(reqs))
    got = {r.rid: toks for r, (toks, _, _) in zip(reqs, outs)}
    assert got == token_streams(ref)
    assert all(done.state == "done" for _, done, _ in outs)


def test_speculation_refused(models):
    cfg, params = models["torch32"]
    assert not tsteps.speculable(cfg)
    with pytest.raises(ValueError, match="codebook"):
        ServingEngine(cfg, slots=2, max_len=32, block_size=8, params=params,
                      device="cpu", spec_ngram=2)
