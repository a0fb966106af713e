"""The port's ServingEngine against the JAX package's, phi4-mini smoke.

Both engines run float32 params (the JAX package's, carried across by the
bridge) and float32 KV pools, on the same ``mixed_spec()`` request stream;
their greedy token streams must be identical in each engine configuration
below, and with the dense live cache (``paged=False``).  In bfloat16 the
port's own invariants must hold bit for bit: mixed dispatch on vs off, and
horizon 4 vs 1."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from serving_harness import materialize, mixed_spec, run_workload, token_streams

from repro.serving import make_requests as jax_make_requests
from repro_torch.bridge import params_from_numpy
from repro_torch.models import registry as tregistry
from repro_torch.serving import ServingEngine, make_requests
from repro_torch.tree import leaves_with_path

ARCH = "phi4-mini-3.8b"
SHARED = mixed_spec(n_requests=6, shared_prefix=16)
ENGINE_CASES = {
    "defaults": {},
    "no_mixed": {"mixed": False},
    "horizon4": {"horizon": 4},
    "swap_pressure": {"n_blocks": 8, "swap_blocks": 32},
    "shared": {"spec": SHARED, "max_len": 64},
}


@pytest.fixture(scope="module")
def models():
    jcfg, jparams = materialize(ARCH)
    host = jax.tree.map(np.asarray, jparams)
    jcfg32 = jcfg.with_overrides(kv_dtype="float32")
    jparams32 = jax.tree.map(lambda a: a.astype(np.float32), jparams)
    tcfg = tregistry.get_smoke(ARCH)
    return {"jax32": (jcfg32, jparams32),
            "torch32": (tcfg.with_overrides(kv_dtype="float32"),
                        params_from_numpy(host, "cpu", dtype=torch.float32)),
            "torch16": (tcfg, params_from_numpy(host, "cpu"))}


def run_port(cfg, params, *, slots=3, max_len=48, block_size=8, spec=None,
             seed=9, **engine_kwargs):
    """The port's twin of ``serving_harness.run_workload``."""
    eng = ServingEngine(cfg, slots=slots, max_len=max_len, block_size=block_size,
                        params=params, device="cpu", **engine_kwargs)
    requests = make_requests(cfg, spec or mixed_spec(), seed=seed)
    summary = eng.run(requests)
    return token_streams(requests), summary, requests


@pytest.fixture(scope="module")
def runs(models):
    """Memoised engine runs: (package, case) → (streams, summary, requests)."""
    cache = {}

    def get(pkg, case):
        if (pkg, case) not in cache:
            kw = dict(ENGINE_CASES[case])
            if pkg == "torch":
                cache[pkg, case] = run_port(*models["torch32"], **kw)
            else:
                streams, summary = run_workload(*models["jax32"], **kw)
                reqs = jax_make_requests(models["jax32"][0],
                                         kw.get("spec") or mixed_spec(), seed=9)
                cache[pkg, case] = (streams, summary, reqs)
        return cache[pkg, case]

    return get


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_greedy_streams_equal_jax_engine(runs, case):
    ours, summary, reqs = runs("torch", case)
    theirs, jsummary, jreqs = runs("jax", case)
    for r, jr in zip(reqs, jreqs):
        np.testing.assert_array_equal(r.prompt, jr.prompt)
    assert ours == theirs
    assert summary["generated_tokens"] == jsummary["generated_tokens"]
    if case == "swap_pressure":
        assert summary["preemptions"]["swap"] > 0
    if case == "shared":
        assert summary["prefix"]["hit_tokens"] > 0


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


def test_summary_has_the_jax_engine_keys(runs):
    assert _keys(runs("torch", "defaults")[1]) == _keys(runs("jax", "defaults")[1])


@pytest.mark.parametrize("flip", [{"mixed": False}, {"horizon": 4}])
def test_bf16_invariants_bit_identical(models, flip):
    base, _, _ = run_port(*models["torch16"])
    other, _, _ = run_port(*models["torch16"], **flip)
    assert base == other


def test_sampling_first_token_matches_and_streams_are_seeded(models):
    kw = dict(temperature=0.8, top_k=20, sample_seed=3)
    ours, _, _ = run_port(*models["torch32"], **kw)
    again, _, _ = run_port(*models["torch32"], **kw)
    theirs, _ = run_workload(*models["jax32"], **kw)
    assert ours == again
    assert {rid: s[0] for rid, s in ours.items()} == {rid: s[0] for rid, s in theirs.items()}


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(tregistry.get_smoke(ARCH), slots=2, max_len=32)


def test_dense_live_cache_matches_jax_engine(models, runs):
    """paged=False: the dense [slots, max_len] live cache and plain sdpa in
    both engines; the streams equal the JAX engine's and the paged run's,
    the cache bytes are the JAX engine's, mixed dispatch and prefix sharing
    are off."""
    ours, summary, _ = run_port(*models["torch32"], paged=False)
    theirs, jsummary = run_workload(*models["jax32"], paged=False)
    assert ours == theirs == runs("torch", "defaults")[0]
    assert summary["kv_cache_bytes"] == jsummary["kv_cache_bytes"]
    assert summary["mixed"]["dispatches"] == 0


def test_zero_block_pool_matches_jax_engine(models):
    """n_blocks=0: both engines build the dense live cache, and both refuse
    every request at submit, since the block pool that budgets it has no
    block to grant."""
    kw = dict(slots=3, max_len=48, block_size=8, n_blocks=0)
    from repro.serving import ServingEngine as JaxEngine
    ours = ServingEngine(*models["torch32"][:1], params=models["torch32"][1],
                         device="cpu", **kw)
    theirs = JaxEngine(models["jax32"][0], params=models["jax32"][1], **kw)
    assert {n for _, n, _ in leaves_with_path(ours.caches)} == {"k", "v", "pos"}
    errors = []
    for eng, mk in ((ours, make_requests), (theirs, jax_make_requests)):
        with pytest.raises(ValueError, match="pool has 0 usable") as e:
            eng.submit(mk(eng.cfg, mixed_spec(), seed=9)[0])
        errors.append(str(e.value))
    assert errors[0] == errors[1]
