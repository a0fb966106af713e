"""xlstm-350m smoke (2 mLSTM + 1 sLSTM layers) through the port's LM and
ServingEngine, against the JAX package.

Weights are the JAX package's ``materialize`` of the smoke config, carried
across by the bridge (``r_zifo`` and the norms stay float32 in a bf16
tree).  The model has no attention layer: its whole decode state is the
cells' float32 state per slot, so the engine holds no pool (no
``paged_attention`` launch), mixed dispatch and prefix sharing turn off by
themselves and raise when forced, and speculation raises (recurrent state
cannot roll back).

* ``count_params`` and ``model_flops`` equal the JAX package's at the smoke
  and the published config (229,086,208 parameters).
* ``lm.forward``: a 12-token prefill (the chunkwise form) and 3 decode
  steps (the token scan), float32, on the static loop's caches and on
  serving caches, logits and cell state within 1e-5.
* Engine greedy streams equal the JAX engine's on ``mixed_spec()``, both in
  float32: defaults, swap pressure (``n_blocks=8, swap_blocks=32``: the
  state rides the swap ticket), recompute pressure (``swap_blocks=0``: the
  slot reset rebuilds ``m = -1e30`` and ``n = 1``), and the port's horizon
  4 and 8 against the JAX horizon 1.  The static loop equals the JAX
  static loop.  bf16 horizon 4 equals horizon 1 bit for bit.
* ODIN's int8 and sc modes: ``lm.forward`` on one short prompt against the
  JAX forward run op by op (``jax.disable_jit``) on the JAX SC tables,
  within 1e-5.
"""
import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from serving_harness import materialize, run_workload
from test_torch_engine import run_port

from repro.core.odin_linear import get_luts as jax_get_luts
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.models import registry as jregistry
from repro.nn import module as jmodule
from repro_torch.bridge import luts_from_numpy, params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.models import registry as tregistry
from repro_torch.nn import blocks as tblocks
from repro_torch.nn import module as tmodule
from repro_torch.serving import ServingEngine
from repro_torch.tree import leaves_with_path, tree_map

ARCH = "xlstm-350m"
FLOAT32_LEAVES = {"r_zifo", "ln1", "out_norm", "final_norm"}
TOL = 1e-5
# the port's cases → (its engine kwargs, the JAX run it must equal)
JAX_CASES = {
    "defaults": {},
    "swap_pressure": {"n_blocks": 8, "swap_blocks": 32},
    "recompute_pressure": {"n_blocks": 8, "swap_blocks": 0},
}
PORT_CASES = {
    "defaults": ({}, "defaults"),
    "swap_pressure": (JAX_CASES["swap_pressure"], "swap_pressure"),
    "recompute_pressure": (JAX_CASES["recompute_pressure"], "recompute_pressure"),
    "horizon4_vs_jax_horizon1": ({"horizon": 4}, "defaults"),
    "horizon8_vs_jax_horizon1": ({"horizon": 8}, "defaults"),
}


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


@pytest.fixture(scope="module")
def jax_runs(models):
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = run_workload(*models["jax32"], **JAX_CASES[case])
        return cache[case]

    return get


def test_bridge_keeps_the_float32_leaves(models):
    """Every leaf crosses bit for bit in the dtype the port's spec gives it:
    ``r_zifo`` and the norms float32, the projections bf16."""
    spec = {p: s for p, _, s in leaves_with_path(tlm.param_spec(models["torch16"][0]))}
    ours = {p: t for p, _, t in leaves_with_path(models["torch16"][1])}
    theirs = {p: a for p, _, a in leaves_with_path(models["host"])}
    assert ours.keys() == theirs.keys() == spec.keys()
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
    assert {"q", "k", "v", "gates", "o_gate", "out", "zifo"} | FLOAT32_LEAVES <= names


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
        assert n == 229_086_208


def _cell_leaves(caches):
    return {p: np.asarray(a) for p, _, a in leaves_with_path(caches)}


@pytest.mark.parametrize("layout", ["static", "serving"])
def test_forward_prefill_then_decode(models, layout):
    """A 12-token prefill (chunkwise, one chunk) and 3 decode steps (the
    token scan), logits and every cell-state leaf within 1e-5."""
    jcfg, jparams = models["jax32"]
    tcfg, tparams = models["torch32"]
    B, max_len = 2, 32
    if layout == "serving":
        jc = jsteps.init_serving_caches(jcfg, B, max_len)
        tc = tsteps.init_serving_caches(tcfg, B, max_len, device="cpu")
    else:
        jc = jlm.init_caches(jcfg, B, max_len)
        tc = tlm.init_caches(tcfg, B, max_len)
    assert [set(seg["cell"]) for seg in tc] == [{"C", "n", "m"}, {"c", "n", "h", "m"}]
    jforward = jax.jit(lambda p, t, c, s: jlm.forward(p, t, jcfg, caches=c, start_pos=s))
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, jcfg.vocab, size=(B, 12)).astype(np.int32)
    jl, jc, _ = jforward(jparams, jnp.asarray(prompt), jc, None)
    tl, tc, _ = tlm.forward(tparams, torch.from_numpy(prompt), tcfg, caches=tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    for step in range(3):
        tok = rng.integers(0, jcfg.vocab, size=(B, 1)).astype(np.int32)
        start = np.full((B, 1), 12 + step, np.int32)
        jl, jc, _ = jforward(jparams, jnp.asarray(tok), jc, jnp.asarray(start))
        tl, tc, _ = tlm.forward(tparams, torch.from_numpy(tok), tcfg, caches=tc,
                                start_pos=torch.from_numpy(start))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    ours, theirs = _cell_leaves(tc), _cell_leaves(jc)
    assert ours.keys() == theirs.keys()
    for p, a in theirs.items():
        assert ours[p].dtype == np.float32 == a.dtype, p
        np.testing.assert_allclose(ours[p], a, atol=TOL, rtol=0, err_msg=p)


@pytest.mark.parametrize("case", list(PORT_CASES))
def test_greedy_streams_equal_jax_engine(models, jax_runs, case):
    kw, jax_case = PORT_CASES[case]
    ours, summary, _ = run_port(*models["torch32"], **kw)
    theirs, jsummary = jax_runs(jax_case)
    assert ours == theirs
    assert set(summary) == set(jsummary)
    assert summary["generated_tokens"] == jsummary["generated_tokens"]
    assert summary["kv_cache_bytes"] == jsummary["kv_cache_bytes"] == 0
    if jax_case == case:
        assert summary["preemptions"] == jsummary["preemptions"]
    if case == "swap_pressure":
        assert summary["preemptions"]["swap"] > 0
    if case == "recompute_pressure":
        assert summary["preemptions"]["recompute"] > 0
    if case.startswith("horizon"):
        assert summary["decode_dispatches"] < summary["decode_steps"]
    assert summary["mixed"]["dispatches"] == 0 and summary["prefix"]["hit_tokens"] == 0


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


def test_static_loop_equals_jax(models):
    tcfg, tparams = models["torch32"]
    jcfg, jparams = models["jax32"]
    batch, prompt_len, gen = 3, 8, 8
    ours, _ = tserve.serve_static(tcfg, batch=batch, prompt_len=prompt_len, gen=gen,
                                  params=tparams, device="cpu", verbose=False)
    prompts = np.stack([r.prompt for r in tserve._batch_requests(
        tcfg, batch, prompt_len, gen, 0)])
    np.testing.assert_array_equal(ours, _jax_static_loop(jcfg, jparams, prompts, gen))


def test_engine_caches_and_gates(models):
    """The cell state per slot, float32 even under an int8 ``kv_dtype``, with
    the true initial state (mLSTM ``m = -1e30``, sLSTM ``n = 1``); no pool;
    mixed dispatch and prefix sharing off by themselves and refused when
    forced; speculation refused; a block refuses a mixed tile's ``q_lens``,
    as the reference's does."""
    cfg, params = models["torch16"]
    kw = dict(slots=2, max_len=32, block_size=8, params=params, device="cpu")
    eng = ServingEngine(cfg.with_overrides(kv_dtype="int8"), **kw)
    assert not eng.paged and not eng.mixed and not eng.prefix_sharing
    assert not tsteps.speculable(cfg)
    leaves = {p: t for p, _, t in leaves_with_path(eng.caches)}
    assert set(leaves) == {"[0]['cell']['C']", "[0]['cell']['n']", "[0]['cell']['m']",
                           "[1]['cell']['c']", "[1]['cell']['n']", "[1]['cell']['h']",
                           "[1]['cell']['m']"}
    assert all(t.dtype == torch.float32 for t in leaves.values())
    assert tuple(leaves["[0]['cell']['C']"].shape) == (2, 2, 2, 32, 32)
    assert tuple(leaves["[1]['cell']['h']"].shape) == (1, 2, 64)
    assert (leaves["[0]['cell']['m']"] == -1e30).all()
    assert (leaves["[1]['cell']['n']"] == 1).all()
    assert eng.summary()["kv_cache_bytes"] == 0
    with pytest.raises(ValueError, match="fully paged"):
        ServingEngine(cfg, mixed=True, **kw)
    with pytest.raises(ValueError, match="fully paged"):
        ServingEngine(cfg, prefix_sharing=True, **kw)
    with pytest.raises(ValueError, match="spec_ngram"):
        ServingEngine(cfg, spec_ngram=2, **kw)
    p0 = tree_map(lambda a: a[0], params["segments"][0])
    with pytest.raises(ValueError, match="q_lens"):
        tblocks.block_apply(p0, torch.zeros((2, 3, cfg.d_model), dtype=torch.bfloat16),
                            cfg.blocks[0], q_lens=torch.ones(2, dtype=torch.int32))


def test_bf16_horizon_invariant_bit_identical(models):
    base, _, _ = run_port(*models["torch16"])
    other, _, _ = run_port(*models["torch16"], horizon=4)
    assert base == other


# the package attribute ``repro_torch.core.odin_linear`` is the function
ODIN_MODULE = sys.modules["repro_torch.core.odin_linear"]


@pytest.mark.parametrize("mode", ["int8", "sc"])
def test_odin_modes_forward_matches_eager_jax(models, mode, monkeypatch):
    """``lm.forward`` in ODIN's int8 or sc mode on one 6-token prompt of 2
    slots, against the JAX forward run op by op (``jax.disable_jit``: under
    ``jit`` XLA divides a quantization scale as a multiply by a rounded
    reciprocal), both on the JAX SC tables: every logit within 1e-5."""
    luts = jax_get_luts(256, 256, 0)      # eagerly, before any trace
    monkeypatch.setattr(ODIN_MODULE, "get_luts",
                        lambda *a, _t=luts_from_numpy(*luts), **k: _t)
    jcfg, jparams = models["jax32"]
    tcfg, tparams = models["torch32"]
    jcfg, tcfg = (c.with_overrides(odin_mode=mode) for c in (jcfg, tcfg))
    tokens = np.random.default_rng(11).integers(0, tcfg.vocab, size=(2, 6)).astype(np.int32)
    with jax.disable_jit():
        jl = np.asarray(jlm.forward(jparams, jnp.asarray(tokens), jcfg)[0])
    tl = tlm.forward(tparams, torch.from_numpy(tokens), tcfg)[0].numpy()
    d = np.abs(tl - jl)
    print(f"xlstm {mode} forward, JAX op by op: max |port - jax| {d.max():.3e}")
    assert d.max() <= TOL


def test_serve_cli(capsys):
    from repro_torch.launch import serve as serve_cli
    serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "8", "--gen", "3"])
    serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "8", "--gen", "3", "--static"])
    out = capsys.readouterr().out
    assert out.count("first request tokens") == 2 and "static prefill" in out
