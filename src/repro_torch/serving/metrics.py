"""Serving observables: latency percentiles, throughput, occupancy, and
per-request ODIN PIMC cost attribution.

The ODIN attribution turns the paper's evaluation instrument (pim/trace's
transaction-level simulator) into a serving-time observable: every token a
request moves through the model — prefill and decode alike — costs one pass
of the active-parameter matmul stack, which maps to a fixed bundle of PIMC
commands (ANN_MUL/ANN_ACC plus the B_TO_S/S_TO_B conversion flows).  A
request's bill is therefore ``per-token command bundle × tokens processed``,
the same workload→command-trace framing RAPIDNN uses, applied per request.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.models import lm
from repro_torch.pim.geometry import OdinModule
from repro_torch.pim.trace import FC, Topology, trace_topology

__all__ = ["EngineStats", "OdinCostModel", "percentiles", "summarize"]


@dataclass
class EngineStats:
    """Counters the engine accumulates across its step loop."""

    steps: int = 0
    decode_steps: int = 0                 # decode *token* steps (horizon inner)
    decode_time: float = 0.0
    prefill_time: float = 0.0
    prefill_tokens: int = 0
    generated_tokens: int = 0             # all emitted tokens (incl. prefill's)
    decode_tokens: int = 0                # tokens emitted by decode steps only
    active_slot_steps: int = 0            # Σ per decode step of active slots
    slot_steps: int = 0                   # Σ per decode step of total slots
    dispatches: int = 0                   # compiled-step launches (prefill+decode)
    decode_dispatches: int = 0            # decode launches only (horizon = 1)
    host_syncs: int = 0                   # blocking device→host syncs
    preempt_swap: int = 0
    preempt_recompute: int = 0
    kv_cache_bytes: int = 0               # device bytes of KV-bearing leaves
    prefix_hit_tokens: int = 0            # prefill rows served from shared blocks
    shared_prefix_blocks: int = 0         # Σ aliased blocks over admissions
    cow_forks: int = 0                    # partial-block copy-on-write forks
    table_block_steps: int = 0            # Σ per step of distinct table blocks
    pool_steps: int = 0                   # steps the occupancy sample covers
    spec_drafted: int = 0                 # n-gram draft tokens verified
    spec_accepted: int = 0                # draft tokens accepted into streams
    spec_overhead_rows: int = 0           # verify rows computed beyond emitted
    mixed_dispatches: int = 0             # fused prefill+decode launches
    mixed_decode_rows: int = 0            # decode rows carried by mixed tiles
    mixed_prefill_rows: int = 0           # prefill rows carried by mixed tiles
    swap_skipped_blocks: int = 0          # swap-out copies skipped (re-attach)
    jit_evictions: int = 0                # fused executables dropped (LRU)
    timeouts: int = 0                     # requests expired (deadline/queue)
    cancelled: int = 0                    # client cancellations (incl. drain)
    failed: int = 0                       # requests quarantined as FAILED
    nan_quarantined: int = 0              # slots isolated by the logit guard
    alloc_faults: int = 0                 # injected pool-allocation failures
    swap_faults: int = 0                  # injected swap copies contained
    faults_injected: int = 0              # fault events applied from the plan
    degrade_level: int = 0                # ladder level at last observation
    degrade_transitions: int = 0          # ladder moves (escalate + restore)
    pool_writes: int = 0                  # cache rows written to PCRAM blocks
    retired_blocks: int = 0               # bad blocks retired from the pool
    scrub_copies: int = 0                 # blocks rewritten (scrub + retire drain)
    scrub_rows: int = 0                   # cache rows those rewrites moved
    wear_p99: float = 0.0                 # p99 of the per-block wear counters
    wear_max: int = 0                     # most-worn block's write count

    @property
    def occupancy(self) -> float:
        return self.active_slot_steps / max(1, self.slot_steps)

    @property
    def mean_referenced_blocks(self) -> float:
        """Steady-state pool occupancy: mean distinct device blocks referenced
        by running block tables per engine step (shared blocks count once —
        the observable prefix sharing shrinks)."""
        return self.table_block_steps / max(1, self.pool_steps)

    @property
    def decode_tps(self) -> float:
        """Decode-phase throughput: decode-emitted tokens over decode time.
        The first token of each request comes out of *prefill* and must not
        inflate this number (its cost sits in prefill_time)."""
        return self.decode_tokens / max(1e-9, self.decode_time)

    @property
    def tokens_per_dispatch(self) -> float:
        """Decode tokens amortized per compiled decode launch — the horizon
        amortization as a first-class observable (1.0 ⇒ no amortization;
        approaches the granted horizon as slots stay busy)."""
        return self.decode_tokens / max(1, self.decode_dispatches)

    @property
    def accept_rate(self) -> float:
        """Fraction of speculative draft tokens the verify step accepted —
        the knob the n-gram speedup rides on (0.0 with speculation off)."""
        return self.spec_accepted / max(1, self.spec_drafted)


class OdinCostModel:
    """Per-token PIMC command/energy bundle for one model config.

    One decoded (or prefilled) token activates ``N_active`` MACs (the
    active-parameter stack, lm.model_flops/2); modeled as an FC layer and
    traced through the five-command set exactly like the paper topologies.
    Pass a *full* arch config to attribute realistic energies even when the
    engine itself runs the smoke config.
    """

    def __init__(self, cfg, module: Optional[OdinModule] = None):
        module = module or OdinModule()
        self.macs_per_token = max(1, int(lm.model_flops(cfg, 1, train=False) / 2))
        topo = Topology(cfg.name, [FC(cfg.d_model, max(1, self.macs_per_token // cfg.d_model))])
        cost = trace_topology(topo, module, accounting="full")
        self.energy_pj_per_token = cost.total_energy_pj
        self.latency_ns_per_token = cost.total_latency_ns
        self.commands_per_token: Dict[str, int] = {}
        for layer in cost.layers:
            for name, n in layer.commands.items():
                self.commands_per_token[name] = self.commands_per_token.get(name, 0) + n

    def attribute(self, n_tokens: int) -> Dict:
        """Cost bill for one request that moved ``n_tokens`` through the model."""
        return {
            "tokens": n_tokens,
            "macs": n_tokens * self.macs_per_token,
            "energy_mj": n_tokens * self.energy_pj_per_token / 1e9,
            "module_latency_ms": n_tokens * self.latency_ns_per_token / 1e6,
            "commands": {k: n_tokens * v for k, v in self.commands_per_token.items()},
        }

    def energy_mj(self, n_rows: int) -> float:
        """Energy bill (mJ) for ``n_rows`` forward rows — the per-dispatch
        quantity trace spans carry, so summing span bills reproduces the
        run's ``odin_total`` exactly."""
        return n_rows * self.energy_pj_per_token / 1e9


def percentiles(xs: List[float], qs=(50, 90, 99)) -> Dict[str, Optional[float]]:
    """Exact percentiles of ``xs``; an empty sample yields ``None`` values —
    NOT ``float("nan")``, which ``json.dumps`` would emit as a bare ``NaN``
    token no strict JSON parser (or Perfetto) accepts."""
    if not xs:
        return {f"p{q}": None for q in qs}
    return {f"p{q}": float(np.percentile(np.asarray(xs, np.float64), q)) for q in qs}


def summarize(requests, stats: EngineStats, cost: Optional[OdinCostModel] = None,
              registry=None) -> Dict:
    """JSON-able roll-up: per-request records + fleet aggregates.

    ``registry`` (a :class:`repro_torch.serving.trace.MetricsRegistry`) adds the
    windowed view — per-window counter deltas and streaming-histogram
    percentiles — under ``"metrics"``; the flat end-of-run aggregates remain
    exact and schema-stable (every field is a superset of the previous PRs').
    ``"engine_stats"`` mirrors every raw :class:`EngineStats` counter so a
    field added to the dataclass can never silently go unreported (CI pins
    the key set to the dataclass fields).
    """
    requests = list(requests)
    per_request = []
    ttfts, tpots = [], []
    for r in sorted(requests, key=lambda r: r.rid):
        ttft = None if r.t_first_token is None else r.t_first_token - r.arrival
        tpot = None
        if r.t_done is not None and r.t_first_token is not None and r.n_generated > 1:
            tpot = (r.t_done - r.t_first_token) / (r.n_generated - 1)
        if ttft is not None:
            ttfts.append(ttft)
        if tpot is not None:
            tpots.append(tpot)
        rec = {
            "rid": r.rid,
            "tenant": r.tenant,
            "arrival_s": r.arrival,
            "prompt_tokens": r.prompt_len,
            "generated_tokens": r.n_generated,
            "prefill_tokens": r.n_prefill_tokens,
            "state": r.state.value,
            "finish_reason": r.finish_reason,
            "ttft_s": ttft,
            "tpot_s": tpot,
            "preemptions": {"swap": r.n_preempt_swap, "recompute": r.n_preempt_recompute},
        }
        if cost is not None:
            # forward rows actually computed: prefill tokens (the request's
            # first generated token falls out of the last prefill pass), one
            # decode row per subsequent emitted token (the final token is
            # emitted without ever being passed back through the model), PLUS
            # the speculative verify rows whose drafts were rejected — each
            # spec inner step runs a K+1-row forward regardless of how many
            # tokens it ends up emitting, so rejected rows are real energy,
            # billed here as ``spec_overhead`` instead of silently vanishing.
            useful = r.n_prefill_tokens + max(0, r.n_generated - 1)
            overhead = getattr(r, "spec_overhead_rows", 0)
            rec["odin"] = cost.attribute(useful + overhead)
            rec["odin"]["spec_overhead"] = {
                "rows": overhead,
                "energy_mj": cost.energy_mj(overhead),
            }
        per_request.append(rec)
    out = {
        "requests": per_request,
        "ttft_s": percentiles(ttfts),
        "tpot_s": percentiles(tpots),
        "decode_tokens_per_s": stats.decode_tps,
        "generated_tokens": stats.generated_tokens,
        "decode_tokens": stats.decode_tokens,
        "prefill_tokens": stats.prefill_tokens,
        "steps": stats.steps,
        "decode_steps": stats.decode_steps,
        "dispatches": stats.dispatches,
        "decode_dispatches": stats.decode_dispatches,
        "host_syncs": stats.host_syncs,
        "tokens_per_dispatch": stats.tokens_per_dispatch,
        "decode_time_s": stats.decode_time,
        "prefill_time_s": stats.prefill_time,
        "slot_occupancy": stats.occupancy,
        "preemptions": {"swap": stats.preempt_swap, "recompute": stats.preempt_recompute},
        "kv_cache_bytes": stats.kv_cache_bytes,
        "prefix": {
            "hit_tokens": stats.prefix_hit_tokens,
            "shared_blocks": stats.shared_prefix_blocks,
            "cow_forks": stats.cow_forks,
            "mean_referenced_blocks": stats.mean_referenced_blocks,
            "swap_skipped_blocks": stats.swap_skipped_blocks,
        },
        "speculation": {
            "drafted": stats.spec_drafted,
            "accepted": stats.spec_accepted,
            "accept_rate": stats.accept_rate,
            "overhead_rows": stats.spec_overhead_rows,
        },
        "mixed": {
            "dispatches": stats.mixed_dispatches,
            "decode_rows": stats.mixed_decode_rows,
            "prefill_rows": stats.mixed_prefill_rows,
        },
        "jit_evictions": stats.jit_evictions,
        # terminal-state matrix: every request ends in exactly one of these
        "terminal": {
            "done": sum(1 for r in requests if r.state.value == "done"),
            "timeout": stats.timeouts,
            "cancelled": stats.cancelled,
            "failed": stats.failed,
        },
        "faults": {
            "injected": stats.faults_injected,
            "alloc": stats.alloc_faults,
            "swap": stats.swap_faults,
            "nan_quarantined": stats.nan_quarantined,
        },
        "degradation": {
            "level": stats.degrade_level,
            "transitions": stats.degrade_transitions,
        },
        # PCRAM reliability: endurance accounting, bad-block retirement, and
        # the drift-refresh scrubber's copy traffic
        "reliability": {
            "pool_writes": stats.pool_writes,
            "retired_blocks": stats.retired_blocks,
            "scrub_copies": stats.scrub_copies,
            "scrub_rows": stats.scrub_rows,
            "wear_p99": stats.wear_p99,
            "wear_max": stats.wear_max,
        },
        # raw counter mirror: keys pinned to the EngineStats dataclass fields
        # (tests/test_trace.py), so new counters surface here automatically
        "engine_stats": dataclasses.asdict(stats),
    }
    if any(r.tenant is not None for r in requests):
        # per-tenant QoS view: the accept-aware bill (emitted tokens), the
        # terminal matrix, latency percentiles and — when a cost model is
        # attached — the ODIN energy split per tenant.  Only materialized on
        # tenanted workloads, so untenanted summaries keep their old schema.
        tenants: Dict[str, Dict] = {}
        for r in sorted(requests, key=lambda r: r.rid):
            key = r.tenant if r.tenant is not None else "_untenanted"
            t = tenants.setdefault(key, {
                "requests": 0, "generated_tokens": 0, "prefill_tokens": 0,
                "terminal": {"done": 0, "timeout": 0, "cancelled": 0,
                             "failed": 0, "live": 0},
                "_ttfts": [], "_tpots": [], "energy_mj": 0.0})
            t["requests"] += 1
            t["generated_tokens"] += r.n_generated
            t["prefill_tokens"] += r.n_prefill_tokens
            state = r.state.value
            t["terminal"][state if state in t["terminal"] else "live"] += 1
            if r.t_first_token is not None:
                t["_ttfts"].append(r.t_first_token - r.arrival)
                if r.t_done is not None and r.n_generated > 1:
                    t["_tpots"].append(
                        (r.t_done - r.t_first_token) / (r.n_generated - 1))
            if cost is not None:
                rows = (r.n_prefill_tokens + max(0, r.n_generated - 1)
                        + getattr(r, "spec_overhead_rows", 0))
                t["energy_mj"] += cost.energy_mj(rows)
        for t in tenants.values():
            t["ttft_s"] = percentiles(t.pop("_ttfts"))
            t["tpot_s"] = percentiles(t.pop("_tpots"))
        out["tenants"] = tenants
    if registry is not None:
        out["metrics"] = registry.summary()
    if cost is not None:
        # phase-attributed energy: rejected speculative rows are verify
        # overhead, not free — and neither are the reliability layer's block
        # rewrites (drift-refresh scrub + retirement drains), which SET/RESET
        # real PCRAM rows.  odin_total is the sum of the phases and (by
        # construction) of every dispatch span's energy bill in a trace.
        phases = {
            "prefill": stats.prefill_tokens,
            "decode": stats.decode_tokens,
            "spec_verify_overhead": stats.spec_overhead_rows,
            "scrub": stats.scrub_rows,
        }
        out["odin_phases"] = {
            name: {"rows": rows, "energy_mj": cost.energy_mj(rows)}
            for name, rows in phases.items()
        }
        out["odin_total"] = cost.attribute(sum(phases.values()))
    return out
