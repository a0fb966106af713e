"""qwen3-moe-235b-a22b smoke through the port's LM and ServingEngine, against
the JAX package.

Weights are the JAX package's ``materialize`` of the smoke config, carried
across by the bridge (the float32 router stays float32 in a bf16 tree).  The
LM forward runs a prefill and decode steps on paged float32 caches, with
and without capacity dropping, within the phi4 test's atol/rtol 1e-4.  The
engines run float32 params and pools on ``mixed_spec()`` in the engine
cases of ``test_torch_engine.py`` and with speculation; their greedy streams
must be equal.  In bfloat16 the reference's own invariants hold
bit for bit inside the port: mixed dispatch on vs off, horizon 4 vs 1,
prefix sharing on vs off, speculation on (K = 4) vs off."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from serving_harness import materialize, mixed_spec, run_workload
from test_torch_engine import ENGINE_CASES as PHI4_ENGINE_CASES
from test_torch_engine import run_port

from repro.launch.steps import init_serving_caches as jax_init_serving_caches
from repro.models import lm as jlm
from repro_torch.bridge import params_from_numpy
from repro_torch.launch.steps import init_serving_caches
from repro_torch.models import lm as tlm
from repro_torch.models import registry as tregistry
from repro_torch.serving import ServingEngine
from repro_torch.tree import leaves_with_path

ARCH = "qwen3-moe-235b-a22b"
SHARED = mixed_spec(n_requests=6, shared_prefix=16)


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


def test_bridge_keeps_the_router_float32(models):
    """The MoE leaves cross bit for bit in their own dtypes: stacked bf16
    experts [L, E, d, F], the float32 router [L, d, E]."""
    ours = {p: t for p, _, t in leaves_with_path(models["torch16"][1])}
    theirs = {p: a for p, _, a in leaves_with_path(models["host"])}
    assert ours.keys() == theirs.keys()
    moe = [p for p in theirs if "['moe']" in p]
    assert {p.rsplit("['", 1)[1][:-2] for p in moe} == {"router", "w_gate", "w_up", "w_down"}
    for p in moe:
        a, t = theirs[p], ours[p]
        assert tuple(t.shape) == a.shape
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                          a.view(np.uint16))
        else:
            assert a.dtype == np.float32 and t.dtype == torch.float32, p
            np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("no_drop", [False, True])
def test_forward_prefill_then_decode_on_paged_caches(models, no_drop):
    jcfg, jparams = models["jax32"]
    tcfg, tparams = models["torch32"]
    B, bs, n_blocks, max_len = 2, 8, 8, 32
    jc = jax_init_serving_caches(jcfg, B, max_len, block_size=bs, n_blocks=n_blocks)
    tc = init_serving_caches(tcfg, B, max_len, block_size=bs, n_blocks=n_blocks,
                             device="cpu")
    tables = np.arange(B * 4, dtype=np.int32).reshape(B, 4)[:, ::-1].copy()
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, jcfg.vocab, size=(B, 12)).astype(np.int32)
    jl, jc, _ = jlm.forward(jparams, jnp.asarray(prompt), jcfg, caches=jc,
                            moe_no_drop=no_drop, tables=jnp.asarray(tables))
    tl, tc, _ = tlm.forward(tparams, torch.from_numpy(prompt), tcfg, caches=tc,
                            moe_no_drop=no_drop, tables=torch.from_numpy(tables))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    for step in range(3):
        tok = rng.integers(0, jcfg.vocab, size=(B, 1)).astype(np.int32)
        pos = np.full((B, 1), 12 + step, np.int32)
        jl, jc, _ = jlm.forward(jparams, jnp.asarray(tok), jcfg, caches=jc,
                                start_pos=jnp.asarray(pos), moe_no_drop=no_drop,
                                tables=jnp.asarray(tables))
        tl, tc, _ = tlm.forward(tparams, torch.from_numpy(tok), tcfg, caches=tc,
                                start_pos=torch.from_numpy(pos), moe_no_drop=no_drop,
                                tables=torch.from_numpy(tables))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(tc[0]["attn"]["pos"].numpy(),
                                  np.asarray(jc[0]["attn"]["pos"]))


def test_capped_prefill_drops(models):
    """The smoke prefill of 24 tokens with capped capacity routes
    differently from drop-free, so the no_drop=False case above holds the
    dropped path."""
    tcfg, tparams = models["torch32"]
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab, size=(2, 12)).astype(np.int32))
    capped = tlm.forward(tparams, tokens, tcfg)[0]
    free = tlm.forward(tparams, tokens, tcfg, moe_no_drop=True)[0]
    assert (capped - free).abs().max() > 1e-3


# test_torch_engine.py's engine cases, and speculation at K = 4
ENGINE_CASES = {**PHI4_ENGINE_CASES, "spec_k4": {"spec_ngram": 4}}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_greedy_streams_equal_jax_engine(models, case):
    kw = ENGINE_CASES[case]
    ours, summary, _ = run_port(*models["torch32"], **kw)
    theirs, jsummary = run_workload(*models["jax32"], **kw)
    assert ours == theirs
    assert summary["generated_tokens"] == jsummary["generated_tokens"]
    if case == "defaults":
        assert summary["mixed"]["dispatches"] > 0
    if case == "swap_pressure":
        assert summary["preemptions"]["swap"] > 0
    if case == "shared":
        assert summary["prefix"]["hit_tokens"] > 0
    if case == "spec_k4":
        assert summary["speculation"] == jsummary["speculation"]


@pytest.mark.parametrize("flip", [
    pytest.param(({}, {"mixed": False}), id="mixed_on_off"),
    pytest.param(({}, {"horizon": 4}), id="horizon_4_1"),
    pytest.param(({"spec": SHARED, "max_len": 64},
                  {"spec": SHARED, "max_len": 64, "prefix_sharing": False}),
                 id="prefix_sharing_on_off"),
    pytest.param(({}, {"spec_ngram": 4}), id="spec_on_off_k4"),
])
def test_bf16_invariants_bit_identical(models, flip):
    base_kw, other_kw = flip
    base, bsum, _ = run_port(*models["torch16"], **base_kw)
    other, osum, _ = run_port(*models["torch16"], **other_kw)
    assert base == other
    if "prefix_sharing" in other_kw:
        assert bsum["prefix"]["hit_tokens"] > 0
    if "spec_ngram" in other_kw:
        assert osum["speculation"]["drafted"] > 0


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(tregistry.get_smoke(ARCH), slots=2, max_len=32)


def test_serve_cli(capsys):
    from repro_torch.launch import serve as serve_cli
    serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "8", "--gen", "3"])
    assert "first request tokens" in capsys.readouterr().out
