"""hymba-1.5b smoke through the port's ServingEngine, against the JAX package.

Weights are the JAX package's ``materialize`` of the smoke config, carried
across by the bridge (the SSM's ``A_log``, ``D`` and ``dt_bias`` and the
block's ``mix_beta`` stay float32 in a bf16 tree).  Both engines run
float32 params and caches on ``mixed_spec()``: sliding-window rings with
``chunk`` rows of headroom and SSM state per slot, the global layer on the
paged pool.  Their greedy streams must be equal with the defaults, under
swap preemption and under recompute preemption (``n_blocks=8``, as in the
JAX package's ``test_engine_preemption_token_streams_identical``), with
rings that wrap under swap preemption, and the
port's horizon-4 streams must equal the JAX engine's horizon-1 ones.  Mixed
dispatch and prefix sharing turn off by themselves and raise when forced;
speculation raises (recurrent state cannot roll back)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from serving_harness import materialize, run_workload
from test_torch_engine import run_port

from repro_torch.bridge import params_from_numpy
from repro_torch.models import lm as tlm
from repro_torch.models import registry as tregistry
from repro_torch.nn import module as tmodule
from repro_torch.serving import ServingEngine
from repro_torch.tree import leaves_with_path

ARCH = "hymba-1.5b"
# JAX engine runs, each shared by the port's cases compared with it
JAX_CASES = {
    "defaults": {},
    "swap_pressure": {"n_blocks": 8, "swap_blocks": 32},
    "recompute_pressure": {"n_blocks": 8, "swap_blocks": 0},
    # chunk 8: rings of 8 + 8 rows, which the 20-40-token requests wrap, and
    # which the swap store clamps to their first 2 blocks
    "ring_wrap_swap": {"prefill_chunk": 8, "n_blocks": 8, "swap_blocks": 32},
}
# port case → (its engine kwargs, the JAX run it must equal)
PORT_CASES = {
    "defaults": ({}, "defaults"),
    "swap_pressure": (JAX_CASES["swap_pressure"], "swap_pressure"),
    "recompute_pressure": (JAX_CASES["recompute_pressure"], "recompute_pressure"),
    "ring_wrap_swap": (JAX_CASES["ring_wrap_swap"], "ring_wrap_swap"),
    "horizon4_vs_jax_horizon1": ({"horizon": 4}, "defaults"),
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


def test_bridge_keeps_the_spec_dtypes(models):
    """Every leaf crosses bit for bit in the dtype the port's spec gives it:
    the SSM's A_log, D and dt_bias and the fusion's mix_beta float32, the
    SSM's conv_w and dt_proj bf16."""
    spec = {p: s for p, _, s in leaves_with_path(tlm.param_spec(models["torch16"][0]))}
    ours = {p: t for p, _, t in leaves_with_path(models["torch16"][1])}
    theirs = {p: a for p, _, a in leaves_with_path(models["host"])}
    assert ours.keys() == theirs.keys() == spec.keys()
    names = {p.rsplit("['", 1)[1][:-2]: p for p in theirs if "['ssm']" in p}
    assert set(names) == {"in_proj", "conv_w", "x_proj", "dt_proj", "dt_bias", "A_log",
                          "D", "out_proj"}
    for p, a in theirs.items():
        t = ours[p]
        assert tuple(t.shape) == a.shape == spec[p].shape, p
        assert t.dtype == spec[p].dtype, p
        if a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                          a.view(np.uint16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)
    for name in ("A_log", "D", "dt_bias"):
        assert ours[names[name]].dtype == torch.float32
    assert ours[names["conv_w"]].dtype == torch.bfloat16
    assert tmodule.count_params(tlm.param_spec(tregistry.get_config(ARCH))) > 1.5e9


@pytest.mark.parametrize("case", list(PORT_CASES))
def test_greedy_streams_equal_jax_engine(models, jax_runs, case):
    kw, jax_case = PORT_CASES[case]
    ours, summary, _ = run_port(*models["torch32"], **kw)
    theirs, jsummary = jax_runs(jax_case)
    assert ours == theirs
    assert summary["generated_tokens"] == jsummary["generated_tokens"]
    assert summary["kv_cache_bytes"] == jsummary["kv_cache_bytes"]
    if jax_case == case:
        assert summary["preemptions"] == jsummary["preemptions"]
    if case in ("swap_pressure", "ring_wrap_swap"):
        assert summary["preemptions"]["swap"] > 0
    if case == "recompute_pressure":
        assert summary["preemptions"]["recompute"] > 0
    if case.startswith("horizon4"):
        assert summary["decode_dispatches"] < summary["decode_steps"]
    assert summary["mixed"]["dispatches"] == 0 and summary["prefix"]["hit_tokens"] == 0


def test_engine_caches_and_gates(models):
    """Rings with the chunk's headroom and SSM state per slot, the global
    layer on the pool; mixed dispatch and prefix sharing off by themselves
    and refused when forced; speculation refused."""
    cfg, params = models["torch16"]
    kw = dict(slots=2, max_len=32, block_size=8, params=params, device="cpu")
    eng = ServingEngine(cfg, **kw)
    assert eng.paged and not eng.mixed and not eng.prefix_sharing
    leaves = {p: t for p, _, t in leaves_with_path(eng.caches)}
    assert tuple(leaves["[0]['attn']['k']"].shape) == (2, 2, 32, 2, 16)   # 8 + 32 → 32
    assert tuple(leaves["[1]['attn']['k_pool']"].shape) == (1, 9, 8, 2, 16)
    assert tuple(leaves["[0]['ssm']['h']"].shape) == (2, 2, 128, 4)
    with pytest.raises(ValueError, match="fully paged"):
        ServingEngine(cfg, mixed=True, **kw)
    with pytest.raises(ValueError, match="fully paged"):
        ServingEngine(cfg, prefix_sharing=True, **kw)
    with pytest.raises(ValueError, match="spec_ngram"):
        ServingEngine(cfg, spec_ngram=2, **kw)


def test_bf16_horizon_invariant_bit_identical(models):
    base, _, _ = run_port(*models["torch16"])
    other, _, _ = run_port(*models["torch16"], horizon=4)
    assert base == other


def test_serve_cli(capsys):
    from repro_torch.launch import serve as serve_cli
    serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "8", "--gen", "3"])
    serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "8", "--gen", "3", "--static"])
    out = capsys.readouterr().out
    assert out.count("first request tokens") == 2 and "static prefill" in out
