"""Fault plans and the guarded decode step of the port's ServingEngine,
phi4-mini smoke.

The engine cases of ``tests/test_faults.py`` run on the port: seeded chaos
plans are contained (no fault escapes ``step()``, every request ends in one
terminal state, the summary is strict JSON), and a NaN-poisoned slot fails
alone while its co-batched neighbours keep their fault-free streams.  Then
the same ``FaultPlan`` replays on both engines with the JAX package's float32
params: equal terminal states, equal firing logs, equal streams."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from serving_harness import materialize, mixed_spec, run_workload
from test_torch_engine import run_port

from repro.serving import FaultPlan as JaxFaultPlan
from repro_torch.bridge import params_from_numpy
from repro_torch.models import registry as tregistry
from repro_torch.serving import FaultEvent, FaultPlan

ARCH = "phi4-mini-3.8b"


@pytest.fixture(scope="module")
def models():
    jcfg, jparams = materialize(ARCH)
    host = jax.tree.map(np.asarray, jparams)
    tcfg = tregistry.get_smoke(ARCH)
    return {"torch16": (tcfg, params_from_numpy(host, "cpu")),
            "torch32": (tcfg.with_overrides(kv_dtype="float32"),
                        params_from_numpy(host, "cpu", dtype=torch.float32)),
            "jax32": (jcfg.with_overrides(kv_dtype="float32"),
                      jax.tree.map(lambda a: a.astype(np.float32), jparams))}


def _conserved(summary, n_requests):
    term = summary["terminal"]
    assert sum(term.values()) == n_requests, term
    json.dumps(summary, allow_nan=False)    # reportable under strict JSON


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_chaos_contained(seed, models):
    """Seeded FaultPlans against the port's engine: no injected fault escapes
    step(), every request lands in exactly one terminal state, and the
    summary stays strict-JSON reportable."""
    plan = FaultPlan.generate(seed, n_steps=64, rate=0.3)
    spec = mixed_spec(5, gen_buckets=(8, 24))
    _, s, _ = run_port(*models["torch16"], slots=3, spec=spec, seed=seed,
                       n_blocks=14, swap_blocks=24, fault_plan=plan, degrade=True,
                       nan_guard=True)
    _conserved(s, 5)
    assert s["fault_plan"]["seed"] == seed
    assert s["fault_plan"]["n_events"] == len(plan) > 0
    assert len(s["fault_plan"]["fired"]) == s["faults"]["injected"] > 0


def test_engine_nan_quarantine_cobatch_bit_identical(models):
    """A poisoned slot fails alone: the quarantined request's stream is a
    prefix of its fault-free run and every other co-batched greedy stream is
    bit-identical to the fault-free baseline."""
    spec = mixed_spec(4, gen_buckets=(16, 32))
    base, _, _ = run_port(*models["torch16"], spec=spec, seed=11)
    plan = FaultPlan(events=(FaultEvent(site="nan_logits", step=8, slot=1),))
    faulted, s1, _ = run_port(*models["torch16"], spec=spec, seed=11, fault_plan=plan)
    assert s1["faults"]["nan_quarantined"] == 1
    [failed] = [r for r in s1["requests"] if r["state"] == "failed"]
    assert failed["finish_reason"] == "nan_logits"
    for rid, stream in faulted.items():
        if rid == failed["rid"]:
            assert stream == base[rid][:len(stream)]   # clean prefix
            assert len(stream) < len(base[rid])
        else:
            assert stream == base[rid], f"unfaulted rid {rid} diverged"
    _conserved(s1, 4)


def test_nan_logits_skipped_with_the_guard_off(models):
    plan = FaultPlan(events=(FaultEvent(site="nan_logits", step=3),))
    _, s, _ = run_port(*models["torch16"], spec=mixed_spec(3), fault_plan=plan,
                       nan_guard=False)
    assert [f["outcome"] for f in s["fault_plan"]["fired"]] == ["skipped-guard-off"]
    assert s["faults"]["nan_quarantined"] == 0 and s["terminal"]["done"] == 3


def test_fault_plan_replay_matches_jax_engine(models):
    """One plan on both engines: a generated plan whose 64 steps fire every
    kind of site (alloc, swap out and in, clock skew, stuck-at, wear
    exhaustion, nan_logits) against a tight pool with a swap tier, plus a
    nan_logits event early in the run."""
    plan = FaultPlan.generate(0, n_steps=64, rate=0.3)
    plan = FaultPlan(plan.events + (FaultEvent(site="nan_logits", step=8, slot=1),),
                     seed=plan.seed)
    jplan = JaxFaultPlan.from_json(plan.to_json())
    kw = dict(spec=mixed_spec(5, gen_buckets=(8, 24)), seed=0, n_blocks=14, swap_blocks=24)
    ours, s, _ = run_port(*models["torch32"], fault_plan=plan, **kw)
    theirs, js = run_workload(*models["jax32"], fault_plan=jplan, **kw)
    assert s["fault_plan"] == js["fault_plan"]
    assert {f["site"] for f in s["fault_plan"]["fired"]} == {e.site for e in plan.events}
    assert [(r["rid"], r["state"], r["finish_reason"]) for r in s["requests"]] == \
        [(r["rid"], r["state"], r["finish_reason"]) for r in js["requests"]]
    assert s["terminal"] == js["terminal"] and s["faults"] == js["faults"]
    assert ours == theirs
    assert s["faults"]["nan_quarantined"] == 2
