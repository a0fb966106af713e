"""ODIN's int8 and sc execution modes on the port's serving path, against the
JAX package, phi4-mini smoke.

Both sides run on the JAX package's SC tables (``bridge.luts_from_numpy``;
the port's own tables come from a ``torch.Generator``) and its float32
params.

* ``nn.layers.linear`` in int8 and sc, float32 and bfloat16 inputs: bit for
  bit against the JAX ``linear`` run op by op (its tests' way: under ``jit``
  XLA divides the scale by 255 as a multiply by a rounded reciprocal).
* The int8 LM's paged prefill against ``lm.forward`` run op by op
  (``jax.disable_jit``), every logit within 1e-5: float32 rounding, no rail
  level moved (measured worst 7.2e-7).
* A prefill tile and three decode tiles through both packages' mixed step
  (``lm.forward`` over paged caches), the JAX side being the JAX engine's
  own compiled step, so that each mode's JAX program is compiled once for
  this test and the engine test.  Tolerances on |port - JAX| over the last
  logits, per mode:

  - int8: 0.05.  The worst measured is 0.0260, with almost every logit past
    1e-4: under ``jit`` a quantization scale moves by an ulp, a weight on a
    rounding boundary lands on the other 8-bit rail level, and the exact
    integer dot moves by one level times the two scales, in every row.  Op
    by op no rail level moves (the prefill test above).
  - sc: 5e-6.  The worst measured is 1.2e-6 (float32 sums in another
    order; no rail level moved at these inputs).

  Both are below 4x the measured worst; the test prints how many logits
  pass 1e-4.
* ``ServingEngine(odin_mode=...)`` against the JAX engine with float32
  params on a short ``mixed_spec`` (3 requests, 4 to 8 tokens each: the
  JAX engine's cost here is its two compiles, not the traffic): greedy
  streams equal, except where a stream parts at a step whose reference
  top-2 logit gap is below the mode's tolerance (the JAX engine runs
  jitted, so in int8 one rail level of 0.05); every such step is printed.
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from serving_harness import materialize, mixed_spec, token_streams

from repro.core.odin_linear import OdinConfig as JaxOdinConfig
from repro.core.odin_linear import get_luts as jax_get_luts
from repro.launch.steps import init_serving_caches as jax_init_serving_caches
from repro.models import lm as jlm
from repro.nn import layers as jlayers
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import Tracer as JaxTracer
from repro.serving import make_requests as jax_make_requests
from repro_torch.bridge import luts_from_numpy, params_from_numpy
from repro_torch.core.odin_linear import OdinConfig
from repro_torch.kernels.sc_mac import sc_mac_cuda
from repro_torch.launch.steps import init_serving_caches, make_serving_mixed_step
from repro_torch.models import lm as tlm
from repro_torch.models import registry as tregistry
from repro_torch.nn import layers as tlayers
from repro_torch.serving import ServingEngine, Tracer, make_requests

ARCH = "phi4-mini-3.8b"
MODES = ("int8", "sc")
LOGIT_TOL = {"int8": 0.05, "sc": 5e-6}
EAGER_TOL = 1e-5
SLOTS, MAX_LEN, BS = 3, 48, 8
SPEC = mixed_spec(3, gen_buckets=(4, 8))

# the package attribute ``repro_torch.core.odin_linear`` is the function
ODIN_MODULE = sys.modules["repro_torch.core.odin_linear"]


def _jax_luts():
    """The JAX tables, computed eagerly.  ``get_luts`` is an ``lru_cache``:
    a first call inside a trace (a jitted sc forward) would cache tracers."""
    luts = jax_get_luts(256, 256, 0)
    if any(isinstance(t, jax.core.Tracer) for t in luts):
        jax_get_luts.cache_clear()
        luts = jax_get_luts(256, 256, 0)
    return luts


@pytest.fixture(scope="module")
def jax_luts():
    return _jax_luts()


@pytest.fixture
def on_jax_luts(jax_luts, monkeypatch):
    """Route the port's SC tables to the JAX package's."""
    tables = luts_from_numpy(*jax_luts)
    monkeypatch.setattr(ODIN_MODULE, "get_luts", lambda *a, **k: tables)
    return tables


@pytest.fixture(scope="module")
def jax_runs(models, jax_luts):
    """The JAX engine over ``SPEC``, once per mode: (engine, streams,
    summary, tracer).  The LM-level test reuses the engine's compiled mixed
    step, so each mode's JAX program is traced and compiled once."""
    runs = {}

    def get(mode):
        if mode not in runs:
            jcfg, jparams = models["jax"]
            tracer = JaxTracer()
            eng = JaxServingEngine(jcfg, slots=SLOTS, max_len=MAX_LEN, block_size=BS,
                                   params=jparams, odin_mode=mode, tracer=tracer)
            reqs = jax_make_requests(jcfg, SPEC, seed=9)
            summary = eng.run(reqs)
            runs[mode] = (eng, token_streams(reqs), summary, tracer)
        return runs[mode]
    return get


@pytest.fixture(scope="module")
def models():
    jcfg, jparams = materialize(ARCH)
    host = jax.tree.map(np.asarray, jparams)
    return {"jax": (jcfg.with_overrides(kv_dtype="float32"),
                    jax.tree.map(lambda a: a.astype(np.float32), jparams)),
            "torch": (tregistry.get_smoke(ARCH).with_overrides(kv_dtype="float32"),
                      params_from_numpy(host, "cpu", dtype=torch.float32))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_linear_bit_identical_to_jax(mode, dtype, on_jax_luts):
    rng = np.random.default_rng(len(mode) + len(dtype))
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 48)) * 0.2).astype(np.float32)
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    theirs = jlayers.linear(jx, jw, JaxOdinConfig(mode=mode))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(getattr(torch, dtype))
    ours = tlayers.linear(tx, tw, OdinConfig(mode=mode))
    assert ours.dtype == tx.dtype and tuple(ours.shape) == (2, 3, 48)
    np.testing.assert_array_equal(ours.float().numpy(),
                                  np.asarray(theirs.astype(jnp.float32)))


def test_exact_mode_keeps_the_compute_dtype():
    x = torch.randn(2, 5, dtype=torch.bfloat16)
    w = torch.randn(5, 3)
    assert torch.equal(tlayers.linear(x, w), torch.matmul(x, w.to(torch.bfloat16)))
    assert torch.equal(tlayers.linear(x, w, OdinConfig(mode="exact")), tlayers.linear(x, w))


def test_sc_tables_built_once_per_device():
    get_luts = ODIN_MODULE.get_luts
    x, w = torch.randn(4, 64), torch.randn(64, 8)
    tlayers.linear(x, w, OdinConfig(mode="sc"))
    before = get_luts.cache_info()
    for _ in range(3):
        tlayers.linear(x, w, OdinConfig(mode="sc"))
    after = get_luts.cache_info()
    assert after.misses == before.misses and after.hits == before.hits + 3


def test_lm_int8_prefill_matches_eager_jax(models, on_jax_luts):
    """The int8 LM's paged prefill against ``lm.forward`` run op by op
    (``jax.disable_jit``: the layer scan unrolled, every division exact),
    every position's logits within float32 rounding."""
    jcfg, jparams = models["jax"]
    tcfg, tparams = models["torch"]
    jcfg, tcfg = (c.with_overrides(odin_mode="int8") for c in (jcfg, tcfg))
    B, bs, n_blocks, max_len = 2, 8, 8, 32
    jc = jax_init_serving_caches(jcfg, B, max_len, block_size=bs, n_blocks=n_blocks)
    tc = init_serving_caches(tcfg, B, max_len, block_size=bs, n_blocks=n_blocks,
                             device="cpu")
    tables = np.arange(B * 4, dtype=np.int32).reshape(B, 4)[:, ::-1].copy()
    tokens = np.random.default_rng(3).integers(0, tcfg.vocab, size=(B, 8)).astype(np.int32)
    with jax.disable_jit():
        jl, jc, _ = jlm.forward(jparams, jnp.asarray(tokens), jcfg, caches=jc,
                                tables=jnp.asarray(tables))
        jl = np.asarray(jl)
    tl, tc, _ = tlm.forward(tparams, torch.from_numpy(tokens), tcfg, caches=tc,
                            tables=torch.from_numpy(tables))
    d = np.abs(tl.numpy() - jl)
    print(f"int8 prefill, JAX op by op: max |port - jax| {d.max():.3e} over {d.size} logits")
    assert d.max() <= EAGER_TOL
    np.testing.assert_array_equal(tc[0]["attn"]["pos"].numpy(), np.asarray(jc[0]["attn"]["pos"]))


@pytest.mark.parametrize("mode", MODES)
def test_lm_prefill_then_decode_within_one_rail_level(mode, models, jax_runs, on_jax_luts):
    """A prefill tile and three decode tiles through both packages' mixed
    step (``lm.forward`` over paged caches).  The JAX side is the JAX
    engine's own step, compiled in its run of the engine test's traffic at
    this tile's shapes, so the test adds no compile; the last logits of
    every slot are compared at each step."""
    jeng = jax_runs(mode)[0]
    jcfg, jparams = jeng.cfg, models["jax"][1]
    tcfg, tparams = models["torch"]
    tcfg = tcfg.with_overrides(odin_mode=mode)
    P = MAX_LEN // BS
    jc = jax_init_serving_caches(jcfg, SLOTS, MAX_LEN, block_size=BS,
                                 n_blocks=SLOTS * P)
    tc = init_serving_caches(tcfg, SLOTS, MAX_LEN, block_size=BS, n_blocks=SLOTS * P,
                             device="cpu")
    jstep, tstep = jeng._mixed_fn(), make_serving_mixed_step(tcfg)
    tables = np.arange(SLOTS * P, dtype=np.int32).reshape(SLOTS, P)[:, ::-1].copy()
    rng = np.random.default_rng(3)
    Q = 16
    q_lens = np.asarray([16, 12, 8], np.int32)
    tok = rng.integers(0, tcfg.vocab, size=(SLOTS, Q)).astype(np.int32)
    lengths = np.zeros(SLOTS, np.int32)
    decode = np.zeros(SLOTS, bool)
    active = np.ones(SLOTS, bool)
    key = jax.random.PRNGKey(0)
    diffs = []
    for step in range(4):                           # the prefill, then 3 decode steps
        jn, jl, jc = jstep(jparams, jc, jnp.asarray(tok), jnp.asarray(lengths),
                           jnp.asarray(q_lens), jnp.asarray(decode), jnp.asarray(active),
                           jnp.asarray(tables), key, jnp.float32(0.0))
        tn, tl, tc = tstep(tparams, tc, *(torch.from_numpy(a) for a in
                                           (tok, lengths, q_lens, decode, active, tables)))
        assert torch.isfinite(tl).all()
        diffs.append(np.abs(tl.numpy() - np.asarray(jl)).ravel())
        lengths = lengths + q_lens
        q_lens = np.ones(SLOTS, np.int32)
        decode = np.ones(SLOTS, bool)
        tok = np.zeros((SLOTS, Q), np.int32)
        tok[:, -1] = rng.integers(0, tcfg.vocab, size=SLOTS)
    d = np.concatenate(diffs)
    print(f"{mode}: max |port - jax| {d.max():.3e}; {(d > 1e-4).sum()} of {d.size} "
          f"logits past 1e-4")
    assert d.max() <= LOGIT_TOL[mode]
    np.testing.assert_array_equal(tc[0]["attn"]["pos"].numpy(), np.asarray(jc[0]["attn"]["pos"]))


def _near_tie(cfg, params, prompt, ours, theirs, mode):
    """The first step where two greedy streams of one request part, with the
    reference's (JAX's) logits there: both tokens must be its top two, and
    their gap below the mode's tolerance."""
    t = next(i for i, (a, b) in enumerate(zip(ours, theirs)) if a != b)
    ctx = np.concatenate([prompt, np.asarray([x[0] for x in theirs[:t]], np.int32)])
    logits = np.asarray(jlm.forward(params, jnp.asarray(ctx[None]), cfg)[0])[0, -1]
    top2 = np.argsort(logits)[::-1][:2]
    gap = float(logits[top2[0]] - logits[top2[1]])
    return t, {ours[t][0], theirs[t][0]} == set(top2.tolist()) and gap < LOGIT_TOL[mode], gap


@pytest.mark.parametrize("mode", MODES)
def test_engine_streams_equal_jax_engine(mode, models, jax_runs, on_jax_luts):
    tcfg, tparams = models["torch"]
    jeng, theirs, jsummary, jtracer = jax_runs(mode)
    sc_mac_cuda.launches = 0
    tracer = Tracer()
    eng = ServingEngine(tcfg, slots=SLOTS, max_len=MAX_LEN, block_size=BS, params=tparams,
                        device="cpu", odin_mode=mode, tracer=tracer)
    assert eng.cfg.odin_mode == mode
    reqs = make_requests(tcfg, SPEC, seed=9)
    summary = eng.run(reqs)
    ours = token_streams(reqs)
    assert sc_mac_cuda.launches == 0                 # CPU tensors take the plain version
    assert summary["terminal"] == jsummary["terminal"]
    # the ODIN cost model's attribution and the dispatch spans' energy bills
    assert summary["odin_total"] == jsummary["odin_total"]
    assert summary["odin_phases"] == jsummary["odin_phases"]

    def bills(t):
        return [(ev.name, ev.args["odin_energy_mj"]) for ev in t.events()
                if ev.args and "odin_energy_mj" in ev.args]
    assert bills(tracer) == bills(jtracer) and len(bills(tracer)) > 0
    for r in reqs:
        if ours[r.rid] != theirs[r.rid]:
            t, tie, gap = _near_tie(jeng.cfg, models["jax"][1], r.prompt, ours[r.rid],
                                    theirs[r.rid], mode)
            print(f"{mode}: rid {r.rid} parts from the JAX engine at step {t}, "
                  f"reference top-2 gap {gap:.3e} (tolerance {LOGIT_TOL[mode]})")
            assert tie, f"rid {r.rid}: streams part at step {t} without a near tie"
            assert ours[r.rid][:t] == theirs[r.rid][:t]


def test_serve_cli_odin_mode(monkeypatch, capsys):
    from repro_torch.launch import serve as serve_cli
    seen = []

    class Recording(ServingEngine):
        def __init__(self, cfg, **kw):
            super().__init__(cfg, **kw)
            seen.append(self.cfg.odin_mode)

    monkeypatch.setattr(serve_cli, "ServingEngine", Recording)
    serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--odin-mode", "int8",
                    "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert seen == ["int8"] and "first request tokens" in capsys.readouterr().out
