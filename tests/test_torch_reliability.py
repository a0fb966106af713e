"""The PCRAM reliability layer and recompute preemption of the port's
ServingEngine against the JAX engine, phi4-mini smoke.

The engine cases of ``tests/test_reliability.py`` run on both engines with
the JAX package's params in float32 (float32 KV) under an injected clock:
each engine reads ``next(count) * TICK``, so the drift scrubber's deadlines
fall on the same engine steps in both.  Streams, terminal states and
``summary()["reliability"]`` (pool writes, scrub copies and rows, retired
blocks, wear) must be equal; the reference's own invariants (reliability on
vs off, a stuck-at block retired without perturbing streams) must hold on
the port too."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from serving_harness import materialize, mixed_spec, run_workload
from test_torch_engine import run_port

from repro.serving import FaultEvent as JaxFaultEvent
from repro.serving import FaultPlan as JaxFaultPlan
from repro.serving import ReliabilityConfig as JaxReliabilityConfig
from repro_torch.bridge import params_from_numpy
from repro_torch.models import registry as tregistry
from repro_torch.serving import FaultEvent, FaultPlan, ReliabilityConfig

ARCH = "phi4-mini-3.8b"
TICK = 1e-3          # seconds a clock read: the 0.02 s drift deadline is 20 reads


def _rel(pkg, **kw):
    return (ReliabilityConfig if pkg == "torch" else JaxReliabilityConfig)(**kw)


def _plan(pkg, *events):
    ev, plan = ((FaultEvent, FaultPlan) if pkg == "torch"
                else (JaxFaultEvent, JaxFaultPlan))
    return plan(events=tuple(ev(**e) for e in events))


# name → (workload kwargs, engine kwargs built per package)
CASES = {
    "on": (dict(spec=mixed_spec(5, gen_buckets=(8, 24)), seed=7, n_blocks=20,
                swap_blocks=24, horizon=4),
           lambda pkg: {"reliability": _rel(pkg, endurance_budget=48, wear_leveling=True,
                                            scrub_rate=2, drift_deadline_s=0.02)}),
    "off": (dict(spec=mixed_spec(5, gen_buckets=(8, 24)), seed=7, n_blocks=20,
                 swap_blocks=24, horizon=4), lambda pkg: {}),
    "budget": (dict(spec=mixed_spec(4, gen_buckets=(16, 32)), seed=3, n_blocks=24),
               lambda pkg: {"reliability": _rel(pkg, endurance_budget=12,
                                                wear_leveling=False)}),
    "budget_base": (dict(spec=mixed_spec(4, gen_buckets=(16, 32)), seed=3, n_blocks=24),
                    lambda pkg: {}),
    "stuck_at": (dict(spec=mixed_spec(4, gen_buckets=(16, 24)), seed=11),
                 lambda pkg: {"fault_plan": _plan(pkg, dict(site="stuck_at", step=6, slot=1),
                                                  dict(site="stuck_at", step=9, slot=5))}),
    "stuck_at_base": (dict(spec=mixed_spec(4, gen_buckets=(16, 24)), seed=11),
                      lambda pkg: {}),
    "wear_storm": (dict(spec=mixed_spec(5, gen_buckets=(8, 24)), seed=2, n_blocks=14,
                        swap_blocks=24, degrade=True),
                   lambda pkg: {"fault_plan": _plan(
                       pkg, dict(site="wear_exhaustion", step=4, count=4),
                       dict(site="wear_exhaustion", step=8, count=4))}),
    "ladder": (dict(spec=mixed_spec(6, gen_buckets=(16, 32)), seed=4, n_blocks=16,
                    swap_blocks=24, degrade=True),
               lambda pkg: {"fault_plan": _plan(
                   pkg, *[dict(site="wear_exhaustion", step=st, count=2)
                          for st in (3, 5, 7, 9)])}),
    "recompute_base": (dict(), lambda pkg: {}),
    "recompute": (dict(n_blocks=8, swap_blocks=0), lambda pkg: {}),
    "recompute_spec": (dict(n_blocks=8, swap_blocks=0, spec_ngram=4), lambda pkg: {}),
}


@pytest.fixture(scope="module")
def models():
    jcfg, jparams = materialize(ARCH)
    host = jax.tree.map(np.asarray, jparams)
    return {"jax32": (jcfg.with_overrides(kv_dtype="float32"),
                      jax.tree.map(lambda a: a.astype(np.float32), jparams)),
            "torch32": (tregistry.get_smoke(ARCH).with_overrides(kv_dtype="float32"),
                        params_from_numpy(host, "cpu", dtype=torch.float32))}


@pytest.fixture(scope="module")
def runs(models):
    """Memoised runs: (package, case) → (streams, summary)."""
    cache = {}

    def get(pkg, case):
        if (pkg, case) not in cache:
            work, extra = CASES[case]
            count = itertools.count()
            kw = dict(work, clock=lambda: next(count) * TICK, **extra(pkg))
            if pkg == "torch":
                streams, summary, _ = run_port(*models["torch32"], **kw)
            else:
                streams, summary = run_workload(*models["jax32"], **kw)
            cache[pkg, case] = (streams, summary)
        return cache[pkg, case]

    return get


def _states(summary):
    return {r["rid"]: (r["state"], r["finish_reason"]) for r in summary["requests"]}


@pytest.mark.parametrize("case", list(CASES))
def test_streams_and_reliability_equal_jax_engine(runs, case):
    ours, s = runs("torch", case)
    theirs, js = runs("jax", case)
    assert ours == theirs
    assert _states(s) == _states(js)
    assert s["reliability"] == js["reliability"]
    assert s["preemptions"] == js["preemptions"]
    if "degradation" in js:
        assert s["degradation"]["transitions"] == js["degradation"]["transitions"]


def test_reliability_on_off_bit_identical(runs):
    base, s0 = runs("torch", "off")
    streams, s1 = runs("torch", "on")
    assert streams == base
    assert _states(s1) == _states(s0)
    r = s1["reliability"]
    assert r["pool_writes"] > 0 and r["scrub_copies"] > 0
    assert r["scrub_rows"] == s1["odin_phases"]["scrub"]["rows"]
    assert s0["reliability"]["pool_writes"] > 0
    assert s0["reliability"]["scrub_rows"] == 0
    assert s0["reliability"]["retired_blocks"] == 0


def test_budget_retirement_drains_and_stays_identical(runs):
    base, _ = runs("torch", "budget_base")
    streams, s = runs("torch", "budget")
    assert streams == base
    assert s["reliability"]["retired_blocks"] > 0
    assert s["reliability"]["scrub_copies"] > 0
    assert s["terminal"].get("done", 0) == 4


def test_stuck_at_contained_and_remapped(runs):
    base, _ = runs("torch", "stuck_at_base")
    streams, s = runs("torch", "stuck_at")
    assert streams == base
    assert s["reliability"]["retired_blocks"] >= 1
    assert sum(s["terminal"].values()) == 4


def test_wear_exhaustion_storm_all_terminal(runs):
    _, s = runs("torch", "wear_storm")
    assert sum(s["terminal"].values()) == 5
    assert s["reliability"]["retired_blocks"] > 0
    failed = [r for r in s["requests"] if r["state"] == "failed"]
    assert all(r["finish_reason"] == "capacity" for r in failed)


def test_retirement_storm_engages_the_ladder(runs):
    _, s = runs("torch", "ladder")
    assert sum(s["terminal"].values()) == 6
    assert s["reliability"]["retired_blocks"] > 0
    assert s["degradation"]["transitions"] > 0


@pytest.mark.parametrize("case", ["recompute", "recompute_spec"])
def test_recompute_preemption_keeps_streams(runs, case):
    base, _ = runs("torch", "recompute_base")
    streams, s = runs("torch", case)
    assert s["preemptions"]["recompute"] > 0 and s["preemptions"]["swap"] == 0
    assert streams == base
