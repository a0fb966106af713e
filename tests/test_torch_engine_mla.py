"""deepseek-v3-671b smoke (MLA + MoE with a shared expert and the route
bias, the MTP subtree) through the port's LM and ServingEngine, against the
JAX package.

Weights are the JAX package's ``materialize`` of the smoke config, carried
across by the bridge (``kv_norm``, ``q_norm``, the router and
``route_bias`` stay float32 in a bf16 tree; the ``mtp`` subtree crosses
whole).  The LM forward runs a prefill and 3 decode steps on the static
loop's caches (scalar ``pos``, capped MoE capacity) and on serving caches
(per-slot ``pos``, drop-free), float32, within the phi4 test's atol/rtol
1e-4.  The engines run float32 params and latent caches on ``mixed_spec()``
and their greedy streams must be equal: defaults, horizon 4, swap
preemption, recompute preemption, n-gram speculation at K = 4 (equal
speculation counters), and the static loop (``serve_static`` against the
JAX ``make_prefill_step``/``make_decode_step``).  The latent cache is dense
per slot, so mixed dispatch and prefix sharing turn off by themselves and
raise when forced; speculation rides the generic S > 1 dense path."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from serving_harness import materialize, run_workload
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
from repro_torch.serving import ServingEngine
from repro_torch.tree import leaves_with_path

ARCH = "deepseek-v3-671b"
FLOAT32_LEAVES = {"kv_norm", "q_norm", "router", "route_bias", "ln1", "ln2", "norm",
                  "final_norm"}


@pytest.fixture(scope="module")
def models():
    jcfg, jparams = materialize(ARCH)
    host = jax.tree.map(np.asarray, jparams)
    tcfg = tregistry.get_smoke(ARCH)
    return {"host": host,
            "jax32": (jcfg.with_overrides(kv_dtype="float32"),
                      jax.tree.map(lambda a: a.astype(np.float32), jparams)),
            "torch32": (tcfg.with_overrides(kv_dtype="float32"),
                        params_from_numpy(host, "cpu", dtype=torch.float32)),
            "torch16": (tcfg, params_from_numpy(host, "cpu"))}


def test_bridge_keeps_the_float32_leaves(models):
    """Every leaf, the ``mtp`` subtree's included, crosses bit for bit in the
    dtype the port's spec gives it; the norms, the router and the route
    bias are float32, the projections bf16."""
    spec = {p: s for p, _, s in leaves_with_path(tlm.param_spec(models["torch16"][0]))}
    ours = {p: t for p, _, t in leaves_with_path(models["torch16"][1])}
    theirs = {p: a for p, _, a in leaves_with_path(models["host"])}
    assert ours.keys() == theirs.keys() == spec.keys()
    assert any(p.startswith("['mtp']['block']['attn']") for p in ours)
    names = set()
    for p, a in theirs.items():
        t, name = ours[p], p.rsplit("['", 1)[1][:-2]
        names.add(name)
        assert tuple(t.shape) == a.shape == spec[p].shape, p
        assert t.dtype == spec[p].dtype, p
        assert (t.dtype == torch.float32) == (name in FLOAT32_LEAVES), p
        if a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                          a.view(np.uint16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)
    assert {"kv_down", "k_up", "v_up", "q_down", "q_up", "shared_gate", "proj"} <= names
    assert FLOAT32_LEAVES <= names


@pytest.mark.parametrize("which", ["get_smoke", "get_config"])
def test_counts_equal_jax(which):
    ours, theirs = getattr(tregistry, which)(ARCH), getattr(jregistry, which)(ARCH)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    n = tmodule.count_params(tlm.param_spec(ours))
    assert n == jmodule.count_params(jlm.param_spec(theirs))
    for train in (True, False):
        assert tlm.model_flops(ours, 7, train=train) == jlm.model_flops(theirs, 7,
                                                                        train=train)
    if which == "get_config":
        assert round(n / 1e9, 2) == 671.71
        assert round(tlm.model_flops(ours, 1, train=False) / 2e9, 2) == 38.24


@pytest.mark.parametrize("layout", ["static_capped", "serving_no_drop"])
def test_forward_prefill_then_decode(models, layout):
    """A 12-token prefill and 3 decode steps: the static loop's caches
    (scalar ``pos``; the prefill routes with capped capacity) or serving
    caches (per-slot ``pos``; every forward drop-free)."""
    jcfg, jparams = models["jax32"]
    tcfg, tparams = models["torch32"]
    B, max_len = 2, 32
    serving = layout == "serving_no_drop"
    if serving:
        jc = jsteps.init_serving_caches(jcfg, B, max_len)
        tc = tsteps.init_serving_caches(tcfg, B, max_len, device="cpu")
    else:
        jc = jlm.init_caches(jcfg, B, max_len)
        tc = tlm.init_caches(tcfg, B, max_len)
    assert set(tc[0]["attn"]) == {"c_kv", "k_rope", "pos"}
    jforward = jax.jit(lambda p, t, c, s: jlm.forward(p, t, jcfg, caches=c, start_pos=s,
                                                      moe_no_drop=serving))
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, jcfg.vocab, size=(B, 12)).astype(np.int32)
    jl, jc, _ = jforward(jparams, jnp.asarray(prompt), jc, None)
    tl, tc, _ = tlm.forward(tparams, torch.from_numpy(prompt), tcfg, caches=tc,
                            moe_no_drop=serving)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    for step in range(3):
        tok = rng.integers(0, jcfg.vocab, size=(B, 1)).astype(np.int32)
        start = (np.full((B, 1), 12 + step, np.int32) if serving
                 else np.asarray(12 + step, np.int32))
        jl, jc, _ = jforward(jparams, jnp.asarray(tok), jc, jnp.asarray(start))
        tl, tc, _ = tlm.forward(tparams, torch.from_numpy(tok), tcfg, caches=tc,
                                start_pos=torch.from_numpy(start), moe_no_drop=serving)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    for seg, jseg in zip(tc, jc):
        np.testing.assert_array_equal(seg["attn"]["pos"].numpy(),
                                      np.asarray(jseg["attn"]["pos"]))
        np.testing.assert_allclose(seg["attn"]["c_kv"].numpy(),
                                   np.asarray(jseg["attn"]["c_kv"]), atol=1e-5)


def _jax_static_loop(cfg, params, prompts, gen):
    prefill = jax.jit(jsteps.make_prefill_step(cfg, max_len=prompts.shape[1] + gen))
    decode = jax.jit(jsteps.make_decode_step(cfg))
    last, caches = prefill(params, {"tokens": jnp.asarray(prompts)})
    tok = jnp.argmax(last, axis=-1).astype(jnp.int32)[:, None]
    outs = []
    for _ in range(gen):
        outs.append(tok)
        tok, caches = decode(params, caches, tok)
    return np.asarray(jnp.concatenate(outs, axis=-1))


ENGINE_CASES = {
    "defaults": {},
    "horizon4": {"horizon": 4},
    "swap_pressure": {"n_blocks": 8, "swap_blocks": 32},
    "recompute_pressure": {"n_blocks": 8, "swap_blocks": 0},
    "spec_k4": {"spec_ngram": 4},
    "static": None,
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_greedy_streams_equal_jax(models, case):
    if case == "static":
        tcfg, tparams = models["torch32"]
        jcfg, jparams = models["jax32"]
        batch, prompt_len, gen = 3, 8, 8
        ours, _ = tserve.serve_static(tcfg, batch=batch, prompt_len=prompt_len, gen=gen,
                                      params=tparams, device="cpu", verbose=False)
        prompts = np.stack([r.prompt for r in tserve._batch_requests(
            tcfg, batch, prompt_len, gen, 0)])
        np.testing.assert_array_equal(ours, _jax_static_loop(jcfg, jparams, prompts, gen))
        return
    kw = ENGINE_CASES[case]
    ours, summary, _ = run_port(*models["torch32"], **kw)
    theirs, jsummary = run_workload(*models["jax32"], **kw)
    assert ours == theirs
    assert summary["generated_tokens"] == jsummary["generated_tokens"]
    assert summary["kv_cache_bytes"] == jsummary["kv_cache_bytes"]
    assert summary["preemptions"] == jsummary["preemptions"]
    if case == "swap_pressure":
        assert summary["preemptions"]["swap"] > 0
    if case == "recompute_pressure":
        assert summary["preemptions"]["recompute"] > 0
    if case == "horizon4":
        assert summary["decode_dispatches"] < summary["decode_steps"]
    if case == "spec_k4":
        assert summary["speculation"]["drafted"] > 0
        assert summary["speculation"] == jsummary["speculation"]
    assert summary["mixed"]["dispatches"] == 0 and summary["prefix"]["hit_tokens"] == 0


def test_engine_caches_and_gates(models):
    """Latent caches dense per slot (no pool); mixed dispatch and prefix
    sharing off by themselves and refused when forced; speculation
    admitted."""
    cfg, params = models["torch16"]
    kw = dict(slots=2, max_len=32, block_size=8, params=params, device="cpu")
    eng = ServingEngine(cfg, **kw)
    assert not eng.paged and not eng.mixed and not eng.prefix_sharing
    assert tsteps.speculable(cfg)
    leaves = {p: t for p, _, t in leaves_with_path(eng.caches)}
    assert set(leaves) == {f"[{i}]['attn']['{n}']" for i in (0, 1)
                           for n in ("c_kv", "k_rope", "pos")}
    assert tuple(leaves["[1]['attn']['c_kv']"].shape) == (2, 2, 32, 32)
    assert tuple(leaves["[0]['attn']['k_rope']"].shape) == (1, 2, 32, 8)
    with pytest.raises(ValueError, match="fully paged"):
        ServingEngine(cfg, prefix_sharing=True, **kw)
    with pytest.raises(ValueError, match="fully paged"):
        ServingEngine(cfg, mixed=True, **kw)
    assert ServingEngine(cfg, spec_ngram=4, **kw).spec_ngram == 4


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(tregistry.get_smoke(ARCH), slots=2, max_len=32)


def test_serve_cli(capsys):
    from repro_torch.launch import serve as serve_cli
    serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "8", "--gen", "3"])
    serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "8", "--gen", "3", "--static"])
    out = capsys.readouterr().out
    assert out.count("first request tokens") == 2 and "static prefill" in out
