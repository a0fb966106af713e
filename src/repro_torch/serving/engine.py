"""Continuous-batching serving engine: the step-loop driver (PyTorch port).

The host half — request lifecycle, scheduling, prefix sharing, preemption,
reliability sweeps, degradation, metrics and tracing — is the JAX package's
``serving/engine.py`` unchanged.  The device half runs the port's eager
serving steps (``launch/steps.py``) on the engine's ``device``:

* the caches hold the physical block pool ``k_pool/v_pool`` per segment;
  prefill writes K/V rows straight into the request's blocks, decode
  attends through the paged kernel (the CUDA kernel on the card);
* mixed dispatch fuses prefill-chunk rows and decode rows into one tile;
* ``horizon > 1`` runs up to ``h`` decode steps per dispatch with the
  token carry kept on the device and one host sync at the end;
* ``spec_ngram = K`` drafts ``K`` tokens a slot by n-gram lookup over an
  on-device token history and verifies them in one ``K+1``-row forward
  (the paged kernel's multi-token tile), up to ``h`` such steps a dispatch;
* swap preemption is a block-to-block index copy on the device;
* a step that a fault plan poisons runs the guarded decode step, whose
  per-slot finiteness verdict quarantines the poisoned request alone.

Host syncs happen where the JAX engine syncs (end of a prefill, the token
readback of each dispatch) and nowhere else.

Not ported yet (see ROADMAP.md): dense caches (``paged=False`` or
non-paged archs) and requests carrying ``extras``.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from contextlib import nullcontext
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch.steps import (init_serving_caches,
                                      make_serving_decode_guarded,
                                      make_serving_decode_horizon,
                                      make_serving_decode_step,
                                      make_serving_mixed_step,
                                      make_serving_spec_horizon,
                                      make_slot_prefill_step, pageable_block,
                                      speculable)
from repro_torch.models import lm
from repro_torch.nn import module as nnmod
from repro_torch.nn.attention import POOL_LEAVES
from repro_torch.serving.blocks import BlockPool, PagedKVStore
from repro_torch.serving.degrade import DegradationController, DegradeConfig
from repro_torch.serving.faults import (EngineStallError, FaultPlan, ShuttingDown,
                                       SwapCopyError)
from repro_torch.serving.metrics import EngineStats, OdinCostModel, summarize
from repro_torch.serving.reliability import ReliabilityConfig
from repro_torch.serving.scheduler import (PrefixCache, PrefixGrant, Request,
                                           RequestState, Scheduler)
from repro_torch.serving.trace import NULL_TRACER, MetricsRegistry
from repro_torch.tree import leaves_with_path

__all__ = ["ServingEngine"]


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet (see ROADMAP.md)")


class ServingEngine:
    """Drives continuous-batching inference over ``slots`` cache slots.

    The parameters are the JAX engine's (see its docstring); the port adds
    ``device`` (default ``"cuda"``; raises when CUDA is absent) and takes
    ``params`` as a tensor tree on that device (:mod:`repro_torch.bridge`
    carries the JAX package's weights across).  ``params=None`` draws
    random weights from a ``torch.Generator`` seeded with ``seed``.

    Differences from the JAX engine:

    * sampling noise comes from ``torch.Generator``s seeded by
      ``(sample_seed, decode step)``: sampled streams are deterministic for
      a seed and horizon-invariant, but not ``jax.random``'s; the first
      sampled token of a request is host-side numpy, as in the JAX engine;
    * ``jit_cache`` bounds the LRU of fused step functions keyed by the
      granted ``(h, spec K)`` (eager functions, no executables; evictions
      are counted as in the JAX engine); ``xla_annotations`` wraps each
      dispatch in a ``torch.profiler.record_function`` range instead;
    * the guarded decode step is an eager function built with the others,
      not an executable compiled on first use;
    * ``paged=False``, models with non-paged segments and requests with
      ``extras`` raise ``NotImplementedError``.
    """

    def __init__(self, cfg: ModelConfig, *, slots: int, max_len: int,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 swap_blocks: int = 0, prefill_chunk: Optional[int] = None,
                 paged: bool = True, prefix_sharing: Optional[bool] = None,
                 mixed: Optional[bool] = None,
                 mixed_budget: Optional[int] = None,
                 horizon: int = 1, spec_ngram: int = 0, spec_hist: int = 64,
                 jit_cache: int = 8,
                 eos_id: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 sample_seed: int = 0,
                 params=None, seed: int = 0, odin_mode: Optional[str] = None,
                 on_token: Optional[Callable] = None,
                 clock: Optional[Callable[[], float]] = None,
                 attribution_cfg: Optional[ModelConfig] = None,
                 tracer=None, metrics_window: float = 1.0,
                 xla_annotations: bool = False,
                 deadline_s: Optional[float] = None,
                 queue_timeout_s: Optional[float] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 nan_guard: Optional[bool] = None,
                 degrade=None,
                 reliability=None,
                 device=None):
        self.device = resolve_device(device)
        if odin_mode is not None:
            cfg = cfg.with_overrides(odin_mode=odin_mode)
        if max_len % block_size:
            raise ValueError(f"max_len {max_len} not divisible by block_size {block_size}")
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        if not paged:
            raise _not_ported("the dense serving cache (paged=False)")
        if not all(pageable_block(b) for b in cfg.blocks):
            raise _not_ported(f"serving {cfg.name}'s non-paged cache families")
        if jit_cache < 1:
            raise ValueError(f"jit_cache must be >= 1, got {jit_cache}")
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.block_size = block_size
        self.n_pages = max_len // block_size
        # Default chunk is bounded: serving prefill routes MoE drop-free, so
        # its expert dispatch buffer scales with the chunk's token count —
        # an unbounded max_len default would pay [E, max_len, d] per layer on
        # full configs.  Drop-free routing is chunk-invariant, so chunking
        # never changes results.
        self.chunk = prefill_chunk or min(max_len, 512)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = nnmod.materialize(lm.param_spec(cfg), gen, self.device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"engine device is {self.device}")
        self.params = params
        self.on_token = on_token
        self._clock = clock or time.monotonic
        self._t0: Optional[float] = None
        self._skew = 0.0
        self._last_now = 0.0
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.sample_seed = int(sample_seed)
        self.horizon = int(horizon)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.spec_ngram = int(spec_ngram)
        self.spec_hist = int(spec_hist)
        self._spec_n = 2                    # n-gram match length (bigram)
        self.jit_cache = int(jit_cache)
        if self.spec_ngram:
            if not speculable(cfg):
                raise ValueError(
                    "spec_ngram needs a single-codebook model whose decode "
                    "state is entirely position-addressed (no SSM/xLSTM "
                    "recurrent segments) — rollback of rejected draft rows "
                    "is a length decrement, which recurrent state and "
                    "codebook frames cannot honor")
            if self.temperature > 0:
                raise ValueError(
                    "spec_ngram is greedy-only (the accept rule compares "
                    "argmaxes); set temperature=0")
            if self.spec_hist < self.spec_ngram + self._spec_n + 1:
                raise ValueError(
                    f"spec_hist {self.spec_hist} too short for K="
                    f"{self.spec_ngram} drafts with {self._spec_n}-gram match")
            # (the JAX engine's sliding-window headroom check has no case
            # here: windowed segments are refused above)

        if n_blocks is None:
            n_blocks = slots * (max_len // block_size)
        self.caches = init_serving_caches(cfg, slots, max_len,
                                          block_size=block_size,
                                          n_blocks=n_blocks, device=self.device)
        self._prefill = make_slot_prefill_step(cfg)
        self._decode = make_serving_decode_step(cfg, top_k=self.top_k)
        self._mixed = make_serving_mixed_step(cfg, top_k=self.top_k)
        self._guarded = make_serving_decode_guarded(cfg, top_k=self.top_k)
        # fused decode functions, one per granted (h, spec K) pair, bounded LRU
        self._fused: "OrderedDict[Tuple[int, int], Callable]" = OrderedDict()

        # ---- PCRAM reliability layer --------------------------------------
        # True → defaults (wear-leveled allocation, no budget, no scrub);
        # ReliabilityConfig → as given; None/False → off.  The wear
        # *accounting* in the pool is always on (pure host bookkeeping).
        if reliability is None or reliability is False:
            self.reliability: Optional[ReliabilityConfig] = None
        elif reliability is True:
            self.reliability = ReliabilityConfig()
        else:
            self.reliability = reliability
        rel = self.reliability
        # blocks flagged bad awaiting drain+retire by the sweep
        self._pending_bad: List[int] = []
        self._gauge_tick = 0
        self.pool = BlockPool(
            n_blocks, block_size,
            policy=("min_wear" if rel is not None and rel.wear_leveling
                    else "lifo"),
            endurance_budget=rel.endurance_budget if rel is not None else None)
        # prefix sharing and mixed dispatch need the block pool to BE the
        # whole model state: every cache leaf lives in the pool or is the
        # per-slot `pos` counter
        fully_paged = all(name in POOL_LEAVES + ("pos",)
                          for _, name, _ in leaves_with_path(self.caches))
        if prefix_sharing is None:
            prefix_sharing = fully_paged
        elif prefix_sharing and not fully_paged:
            raise ValueError("prefix_sharing=True needs a fully paged cache layout")
        self.prefix_sharing = bool(prefix_sharing)
        if mixed is None:
            mixed = fully_paged
        elif mixed and not fully_paged:
            raise ValueError("mixed=True needs a fully paged cache layout")
        self.mixed = bool(mixed)
        self.mixed_budget = int(mixed_budget if mixed_budget is not None
                                else self.chunk + slots)
        if self.mixed and self.mixed_budget < 2:
            raise ValueError(
                f"mixed_budget must be >= 2 (one decode row plus one prefill "
                f"row), got {self.mixed_budget}")
        prefix_cache = (PrefixCache(self.pool, block_size)
                        if self.prefix_sharing else None)
        self.store = (PagedKVStore(self.caches, swap_blocks, block_size)
                      if swap_blocks else None)
        self.sched = Scheduler(slots, self.pool, max_len,
                               swap_pool=self.store.pool if self.store else None,
                               prefix_cache=prefix_cache,
                               write_span=self.spec_ngram + 1)
        # under mixed dispatch a prompt chain is registered only once its
        # staged replay finishes (Scheduler.finish_prefill)
        self.sched.defer_prefix_register = self.mixed
        self.stats = EngineStats()
        self.stats.kv_cache_bytes = self._kv_bytes()
        self.cost_model = OdinCostModel(attribution_cfg or cfg)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.tracer.set_clock(self._now)
        self.sched.tracer = self.tracer
        self.pool.tracer = self.tracer
        if self.store is not None:
            self.store.pool.tracer = self.tracer
        self.metrics = MetricsRegistry(window_s=metrics_window)
        self.metrics.maybe_roll(self._now(), self._counter_snapshot())
        self.xla_annotations = bool(xla_annotations)

        # ---- robustness substrate ----------------------------------------
        self.deadline_s = deadline_s
        self.queue_timeout_s = queue_timeout_s
        self.fault_plan = fault_plan
        self._nan_guard = (bool(nan_guard) if nan_guard is not None
                           else fault_plan is not None)
        if degrade is None or degrade is False:
            self.degrade = None
        elif degrade is True:
            self.degrade = DegradationController(tracer=self.tracer)
        elif isinstance(degrade, DegradeConfig):
            self.degrade = DegradationController(degrade, tracer=self.tracer)
        else:
            self.degrade = degrade
        self.draining = False
        self._watched: List[Request] = []
        self._by_rid: Dict[int, Request] = {}
        self._churn_mark = 0
        self._spec_mark = (0, 0)

        self._last_tok = torch.zeros((slots, 1), dtype=torch.int32, device=self.device)
        # per-slot token-history ring for the on-device n-gram draft match
        # (right-aligned, -1 padded; shifted on the device by every decode)
        self._hist = (torch.full((slots, self.spec_hist), -1, dtype=torch.int32,
                                 device=self.device) if self.spec_ngram else None)
        self._slot_len = np.zeros(slots, np.int32)
        self._tables = np.zeros((slots, self.n_pages), np.int32)
        self._tables_dev = torch.as_tensor(self._tables, device=self.device)
        self._synced_version = self.sched.table_version
        self._done: List[Request] = []

    # ------------------------------------------------------------------ util

    def _now(self) -> float:
        if self._t0 is None:
            self._t0 = self._clock()
        t = self._clock() - self._t0 + self._skew
        if t < self._last_now:          # monotone clamp (clock-skew faults)
            t = self._last_now
        else:
            self._last_now = t
        return t

    def _kv_bytes(self) -> int:
        """Device bytes held by the KV pool leaves."""
        return int(sum(leaf.numel() * leaf.element_size()
                       for _, name, leaf in leaves_with_path(self.caches)
                       if name in POOL_LEAVES))

    def _dev(self, array) -> torch.Tensor:
        return torch.as_tensor(array, device=self.device)

    def _generator(self, step: int) -> Optional[torch.Generator]:
        """Sampling noise of decode step ``step`` (None when greedy)."""
        if self.temperature <= 0:
            return None
        seed = (self.sample_seed * 1_000_003 + step) % (2**63)
        return torch.Generator(device=self.device).manual_seed(seed)

    @staticmethod
    def _slot_track(slot: int) -> str:
        return f"slot {slot}"

    def _annotate(self, kind: str):
        """Optional profiler range around a dispatch, so device timelines
        line up with the engine's own spans."""
        if self.xla_annotations:
            return torch.profiler.record_function(f"serving/{kind}")
        return nullcontext()

    def _counter_snapshot(self) -> Dict[str, float]:
        """Cumulative counters the metrics registry turns into window deltas."""
        st = self.stats
        return {"generated_tokens": st.generated_tokens,
                "decode_tokens": st.decode_tokens,
                "prefill_tokens": st.prefill_tokens,
                "dispatches": st.dispatches,
                "decode_dispatches": st.decode_dispatches,
                "mixed_dispatches": st.mixed_dispatches,
                "host_syncs": st.host_syncs,
                "preempt_swap": st.preempt_swap,
                "preempt_recompute": st.preempt_recompute,
                "spec_drafted": st.spec_drafted,
                "spec_accepted": st.spec_accepted,
                "spec_overhead_rows": st.spec_overhead_rows,
                "decode_time_s": st.decode_time,
                "prefill_time_s": st.prefill_time,
                "pool_writes": st.pool_writes,
                "retired_blocks": st.retired_blocks,
                "scrub_copies": st.scrub_copies,
                "scrub_rows": st.scrub_rows}

    def _set_last_tok(self, slot: int, tok) -> None:
        self._last_tok[slot] = int(np.ravel(tok)[0])

    def _seed_hist(self, req: Request) -> None:
        """(Re)build the slot's draft-match history from the request's full
        token context (prompt + every generated token, pending included),
        on the host at admission and resume only."""
        ctx = np.concatenate([np.asarray(req.replay_tokens(), np.int32).ravel(),
                              np.ravel(req.generated[-1]).astype(np.int32)])
        row = np.full(self.spec_hist, -1, np.int32)
        tail = ctx[-self.spec_hist:]
        row[self.spec_hist - len(tail):] = tail
        self._hist[req.slot] = self._dev(row)

    def _shift_hist(self, nxt, mask) -> None:
        """Shift each masked slot's one new token into its history ring
        (the plain, guarded and mixed steps; the spec step shifts its own)."""
        if self.spec_ngram:
            shifted = torch.cat([self._hist[:, 1:], nxt], dim=1)
            self._hist = torch.where(mask[:, None], shifted, self._hist)

    def _refresh_tables(self) -> torch.Tensor:
        """Device mirror of running requests' block tables ([slots, P] int32),
        uploaded only on steps where some table changed
        (``Scheduler.table_version``).  Entries past a table's length are
        stale ids — harmless, the kernel masks pages at or beyond the slot's
        length."""
        if self._synced_version != self.sched.table_version:
            for slot, req in self.sched.running.items():
                bt = req.block_table
                self._tables[slot, :len(bt)] = bt
            self._tables_dev = self._dev(self._tables)
            self._synced_version = self.sched.table_version
        return self._tables_dev

    def _first_token(self, last_logits, req: Request) -> np.ndarray:
        """The request's first generated token from its prefill logits
        (host float32 array ``[1, V]``): greedy, or the engine's
        temperature/top-k sampling with a per-request numpy key."""
        logits = np.asarray(last_logits, np.float32)[0]        # [V]
        if self.temperature <= 0:
            return np.argmax(logits, axis=-1).astype(np.int32)
        if self.top_k:
            kth = np.sort(logits, axis=-1)[..., -self.top_k, None]
            logits = np.where(logits >= kth, logits, -np.inf)
        rng = np.random.default_rng((self.sample_seed, req.rid))
        z = logits / max(self.temperature, 1e-6) + rng.gumbel(size=logits.shape)
        z = np.where(np.isfinite(logits), z, -np.inf)
        return np.argmax(z, axis=-1).astype(np.int32)

    def _emit(self, req: Request, tok: np.ndarray, now: float) -> None:
        req.generated.append(tok)
        self.stats.generated_tokens += 1
        if self.eos_id is not None and int(np.ravel(tok)[0]) == self.eos_id:
            req.eos = True
        if req.t_first_token is None:
            req.t_first_token = now
            ttft = max(0.0, now - req.arrival)
            self.metrics.observe("ttft_s", ttft)
            if req.tenant is not None:
                self.metrics.observe(f"ttft_s/{req.tenant}", ttft)
        if self.on_token is not None:
            self.on_token(req, tok, now)

    # ------------------------------------------------------------- lifecycle

    def submit(self, req: Request) -> None:
        if self.draining:
            raise ShuttingDown(
                f"request {req.rid}: engine is draining — submissions after "
                f"drain() begin get a typed rejection, never a silent hang")
        if req.extras:
            raise _not_ported(f"request {req.rid}: extras (patch_embeds/pos3d)")
        if req.deadline is None and self.deadline_s is not None:
            req.deadline = req.arrival + self.deadline_s
        if req.queue_timeout is None and self.queue_timeout_s is not None:
            req.queue_timeout = self.queue_timeout_s
        self.sched.submit(req)
        self._by_rid[req.rid] = req
        if (req.deadline is not None or req.queue_timeout is not None
                or req.cancel_at is not None):
            self._watched.append(req)
        if self.tracer.enabled:
            t = self._now()
            self.tracer.flow_event("s", "request", "scheduler", req.rid, ts=t)
            args = {"rid": req.rid, "prompt_tokens": req.prompt_len,
                    "max_new": req.max_new}
            if req.tenant is not None:
                args["tenant"] = req.tenant
            self.tracer.instant("queued", "lifecycle", "scheduler", ts=t,
                                args=args, flow=req.rid)

    def _complete(self, req: Request, now: float) -> None:
        slot = req.slot
        self.sched.complete(req, now)
        self._done.append(req)
        if req.t_first_token is not None and req.n_generated > 1:
            tpot = max(0.0, (now - req.t_first_token) / (req.n_generated - 1))
            self.metrics.observe("tpot_s", tpot)
            if req.tenant is not None:
                self.metrics.observe(f"tpot_s/{req.tenant}", tpot)
        if self.tracer.enabled:
            track = self._slot_track(slot) if slot >= 0 else "scheduler"
            args = {"rid": req.rid, "generated_tokens": req.n_generated,
                    "eos": bool(req.eos)}
            if req.tenant is not None:
                args["tenant"] = req.tenant
            self.tracer.instant("complete", "lifecycle", track, ts=now,
                                args=args, flow=req.rid)
            self.tracer.flow_event("f", "request", track, req.rid, ts=now)

    _TERMINAL_EVENT = {RequestState.TIMEOUT: "timeout",
                       RequestState.CANCELLED: "cancel",
                       RequestState.FAILED: "failed"}

    def _finalize(self, req: Request, state: RequestState, reason: str,
                  now: float) -> None:
        """Release a live request into a non-DONE terminal state."""
        slot = req.slot
        self.sched.release(req, state, now, reason)
        self._done.append(req)
        if state is RequestState.TIMEOUT:
            self.stats.timeouts += 1
        elif state is RequestState.CANCELLED:
            self.stats.cancelled += 1
        else:
            self.stats.failed += 1
        if self.tracer.enabled:
            track = self._slot_track(slot) if slot >= 0 else "scheduler"
            args = {"rid": req.rid, "reason": reason,
                    "generated_tokens": req.n_generated}
            if req.tenant is not None:
                args["tenant"] = req.tenant
            self.tracer.instant(
                self._TERMINAL_EVENT[state], "lifecycle", track, ts=now,
                args=args, flow=req.rid)
            self.tracer.flow_event("f", "request", track, req.rid, ts=now)

    def cancel(self, rid: int, reason: str = "client") -> bool:
        """Client-side cancellation of request ``rid`` from any live state.
        Returns False when the rid is unknown or already terminal."""
        req = self._by_rid.get(rid)
        if req is None or req.terminal:
            return False
        self._finalize(req, RequestState.CANCELLED, reason, self._now())
        return True

    def _expire(self, now: float) -> None:
        """Sweep watched requests for scripted cancellations, deadlines and
        queue timeouts at the top of each step."""
        alive: List[Request] = []
        for req in self._watched:
            if req.terminal:
                continue
            if req.cancel_at is not None and now >= req.cancel_at:
                self._finalize(req, RequestState.CANCELLED, "client", now)
            elif req.deadline is not None and now >= req.deadline:
                self._finalize(req, RequestState.TIMEOUT, "deadline", now)
            elif (req.queue_timeout is not None and req.t_admit is None
                    and now >= req.arrival + req.queue_timeout):
                self._finalize(req, RequestState.TIMEOUT, "queue", now)
            else:
                alive.append(req)
        self._watched = alive

    def _apply_faults(self, now: float):
        """Consume this step's fault events from the plan.  Arming faults
        (alloc/swap/clock) mutate the seams directly; stuck-at and wear
        exhaustion flag blocks for the reliability sweep; a ``nan_logits``
        event is returned for the decode phase to inject through the guarded
        step."""
        nan_ev = None
        for ev in self.fault_plan.events_at(self.stats.steps):
            self.stats.faults_injected += 1
            if ev.site == "alloc":
                self.pool.arm_alloc_failures(ev.count)
                self.stats.alloc_faults += ev.count
                self.fault_plan.record(ev, "armed", count=ev.count)
            elif ev.site in ("swap_out", "swap_in"):
                if self.store is None:
                    self.fault_plan.record(ev, "skipped-no-swap-tier")
                else:
                    self.store.arm_swap_failures(ev.site[5:], ev.count)
                    self.fault_plan.record(ev, "armed", count=ev.count)
            elif ev.site == "clock_skew":
                self._skew += ev.skew_s
                self.fault_plan.record(ev, "applied", skew_s=ev.skew_s)
            elif ev.site == "stuck_at":
                # one PCRAM block develops a stuck-at cell: the sweep drains
                # and retires it before the next dispatch
                if self.pool.n_blocks == 0:
                    self.fault_plan.record(ev, "skipped-empty-pool")
                else:
                    bid = ev.slot % self.pool.n_blocks
                    if bid in self.pool.retired:
                        self.fault_plan.record(ev, "already-retired", block=bid)
                    else:
                        self._pending_bad.append(bid)
                        self.fault_plan.record(ev, "flagged", block=bid)
            elif ev.site == "wear_exhaustion":
                # the count most-worn live blocks burn through their
                # remaining endurance at once: a retirement storm
                order = np.argsort(self.pool.wear, kind="stable")[::-1]
                picked = [int(b) for b in order
                          if int(b) not in self.pool.retired][:ev.count]
                self._pending_bad.extend(picked)
                self.fault_plan.record(ev, "flagged", blocks=picked)
            elif ev.site == "nan_logits":
                if self._nan_guard:
                    nan_ev = ev
                else:
                    self.fault_plan.record(ev, "skipped-guard-off")
            if self.tracer.enabled:
                self.tracer.instant("fault-inject", "faults", "scheduler",
                                    ts=now, args={"site": ev.site,
                                                  "step": ev.step,
                                                  "count": ev.count})
        return nan_ev

    def _observe_degrade(self, now: float) -> None:
        """Feed the controller this step's observables and push its knobs
        into the scheduler (admission hold, prefix retention)."""
        ctl = self.degrade
        churn_now = self.stats.preempt_swap + self.stats.preempt_recompute
        churn = churn_now - self._churn_mark
        self._churn_mark = churn_now
        d_draft = self.stats.spec_drafted - self._spec_mark[0]
        d_acc = self.stats.spec_accepted - self._spec_mark[1]
        self._spec_mark = (self.stats.spec_drafted, self.stats.spec_accepted)
        ctl.observe(
            now,
            pool_frac=self.pool.used_blocks / max(1, self.pool.usable_blocks),
            queue_depth=sum(1 for a, _, _ in self.sched.waiting if a <= now),
            churn=churn,
            accept_rate=(d_acc / d_draft) if d_draft else None,
            est_step_time=self._est_step_time(),
            active=len(self.sched.running),
            retired_frac=len(self.pool.retired) / max(1, self.pool.n_blocks))
        self.sched.admission_hold = (ctl.retry_after(now)
                                     if ctl.deny_admission else None)
        self.sched.prefix_retain = not ctl.release_prefix
        cache = self.sched.prefix_cache
        if ctl.release_prefix and cache is not None:
            n = cache.reclaimable()
            if n:
                cache.reclaim(n)
        self.stats.degrade_level = ctl.level
        self.stats.degrade_transitions = ctl.transitions

    def drain(self, max_steps: int = 100_000) -> Dict:
        """Graceful shutdown: cancel every request that never started, then
        drive the loop until all in-flight work finishes.  Returns the final
        summary."""
        self.draining = True
        now = self._now()
        for _, _, req in list(self.sched.waiting):
            if req.t_admit is None:
                self._finalize(req, RequestState.CANCELLED, "drain", now)
        steps = 0
        while self.sched.has_work:
            self.step()
            steps += 1
            if steps > max_steps:
                raise EngineStallError(
                    f"drain exceeded {max_steps} steps",
                    summary=self.summary())
        return self.summary()

    def _copy_blocks(self, src: List[int], dst: List[int]) -> None:
        """Copy pool blocks ``src`` into ``dst`` on every pool leaf, in place
        (all sources are read before any destination is written)."""
        s, d = self._dev(src).long(), self._dev(dst).long()
        for _, name, leaf in leaves_with_path(self.caches):
            if name in POOL_LEAVES:
                leaf[:, d] = leaf[:, s]

    def _cow_fork(self, src: int, dst: int) -> None:
        """Execute a COW fork: copy pool block ``src`` into ``dst`` before the
        forking slot writes its tail rows into ``dst``."""
        t0 = self._now() if self.tracer.enabled else 0.0
        self._copy_blocks([src], [dst])
        self.stats.cow_forks += 1
        self.pool.record_writes([(dst, self.block_size)], self._now())
        self.stats.pool_writes = self.pool.total_writes
        if self.tracer.enabled:
            self.tracer.span("cow-copy", "dispatch", "pool", t0,
                             self._now() - t0,
                             args={"kind": "cow-copy", "src": src, "dst": dst})

    # ------------------------------------------------- PCRAM reliability

    def _record_writes(self, req: Request, start: int, rows: int,
                       now: float) -> None:
        """Host-side endurance mirror of one dispatch's KV writes: bill rows
        ``[start, start+rows)`` of the request's sequence to the pool blocks
        its table maps them to (rows past the table's span went to the
        write-off block and are skipped)."""
        if rows <= 0:
            return
        bs = self.block_size
        table = req.block_table
        pairs = []
        row = start
        end = min(start + rows, self.max_len)
        while row < end:
            bi = row // bs
            if bi >= len(table):
                break
            n = min(end, (bi + 1) * bs) - row
            pairs.append((table[bi], n))
            row += n
        if pairs:
            self.pool.record_writes(pairs, now)
            self.stats.pool_writes = self.pool.total_writes

    def _update_wear_gauges(self) -> None:
        if self.pool.n_blocks:
            self.stats.wear_p99 = float(np.percentile(self.pool.wear, 99))
            self.stats.wear_max = int(self.pool.wear.max())

    def _maybe_update_wear_gauges(self) -> None:
        """Per-step gauge refresh, throttled to every 16th sweep;
        ``summary()`` recomputes exactly at read time."""
        self._gauge_tick = (self._gauge_tick + 1) % 16
        if self._gauge_tick == 0:
            self._update_wear_gauges()

    def _block_rewrite(self, pairs: List[Tuple[int, int]], kind: str,
                       now: float) -> None:
        """Execute block copies on the physical store and bill them: each
        ``(src, dst)`` pair copies identical bytes (``src == dst`` for a drift
        refresh in place, which moves no bytes and is billed only), costs one
        block of PCRAM writes at the destination, and is traced as a
        ``scrub`` span carrying its ODIN energy."""
        if not pairs:
            return
        t0 = self._now()
        moves = [(s, d) for s, d in pairs if s != d]
        if moves:
            self._copy_blocks([s for s, _ in moves], [d for _, d in moves])
        rows = len(pairs) * self.block_size
        self.pool.record_writes([(d, self.block_size) for _, d in pairs], now)
        self.stats.pool_writes = self.pool.total_writes
        self.stats.scrub_copies += len(pairs)
        self.stats.scrub_rows += rows
        if self.tracer.enabled:
            self.tracer.span(
                "scrub", "dispatch", "pool", t0, self._now() - t0,
                args={"kind": kind, "blocks": len(pairs), "rows": rows,
                      "odin_energy_mj": self.cost_model.energy_mj(rows)})

    def _reliability_sweep(self, now: float) -> None:
        """Bad-block retirement + drift-refresh scrubbing, run before
        ``plan()`` so no dispatch is in flight while block ids move."""
        rel = self.reliability
        bad = list(self._pending_bad)
        if rel is not None and rel.endurance_budget is not None:
            bad.extend(self.pool.over_budget())
        if bad:
            bad = sorted(set(bad))
            copies = self.sched.retire_blocks(bad)
            self._pending_bad = [b for b in bad if b not in self.pool.retired]
            self._block_rewrite(copies, "retire-drain", now)
            self.stats.retired_blocks = len(self.pool.retired)
            if self.tracer.enabled and copies:
                self.tracer.counter(
                    "retired blocks", "pool",
                    {"retired": len(self.pool.retired),
                     "usable": self.pool.usable_blocks})
            usable = self.pool.usable_blocks
            for req in self._all_live():
                if self.pool.blocks_for(req.prompt_len + req.max_new) > usable:
                    self._finalize(req, RequestState.FAILED, "capacity", now)
        if rel is not None and rel.scrub_enabled:
            self._scrub(now, rel)
        self._maybe_update_wear_gauges()

    def _scrub(self, now: float, rel: ReliabilityConfig) -> None:
        """Drift refresh: rewrite the oldest-written resident blocks in place,
        at most ``scrub_rate`` per step, once their last write is older than
        the drift deadline."""
        lw = self.pool.last_write
        cand = np.flatnonzero((lw >= 0) & (now - lw >= rel.drift_deadline_s))
        due = [int(b) for b in cand
               if self.pool.refs(int(b)) > 0 and int(b) not in self.pool.retired]
        if not due:
            return
        due.sort(key=lambda b: lw[b])
        batch = due[:rel.scrub_rate]
        self._block_rewrite([(b, b) for b in batch], "drift-refresh", now)

    def _all_live(self) -> List[Request]:
        live = [r for _, _, r in self.sched.waiting]
        live += list(self.sched.swapped)
        live += list(self.sched.running.values())
        return [r for r in live if not r.terminal]

    def _apply_grant(self, grant: Optional[PrefixGrant]) -> int:
        """Run a shared-prefix grant's COW fork and accounting; returns the
        first replay row the request still has to prefill."""
        if grant is None:
            return 0
        if grant.fork is not None:
            self._cow_fork(*grant.fork)
        self.stats.prefix_hit_tokens += grant.start
        self.stats.shared_prefix_blocks += grant.shared_blocks
        return grant.start

    def _prefill_request(self, req: Request, now: float,
                         grant: Optional[PrefixGrant] = None) -> None:
        """Chunked prefill into the request's slot; emits the first token for
        fresh admissions (readmitted requests already hold their pending
        token).  A shared-prefix ``grant`` skips the resident rows."""
        fresh = req.n_generated == 0
        toks = req.replay_tokens()
        ntok = toks.shape[-1]
        start0 = self._apply_grant(grant)
        trace = self.tracer.enabled
        t0 = self._now()
        chunk_sizes: List[int] = []
        tables = self._refresh_tables()
        start = start0
        ll = None
        with self._annotate("prefill"):
            while start < ntok:
                c = min(self.chunk, ntok - start)
                chunk_toks = self._dev(np.asarray(toks[..., start:start + c], np.int32)[None])
                ll, self.caches = self._prefill(
                    self.params, self.caches, chunk_toks, req.slot, start,
                    start == start0, tables)
                self.stats.dispatches += 1
                chunk_sizes.append(c)
                start += c
            ll = ll.float().cpu().numpy()                 # syncs the prefill
        wall = self._now() - t0
        self.stats.host_syncs += 1
        self.stats.prefill_time += wall
        self.stats.prefill_tokens += ntok - start0
        req.n_prefill_tokens += ntok - start0
        self.metrics.observe("dispatch_prefill_s", wall)
        if trace:
            span = wall
            track = self._slot_track(req.slot)
            total = max(1, ntok - start0)
            self.tracer.flow_event("t", "request", track, req.rid, ts=t0)
            off, pos = t0, start0
            for i, c in enumerate(chunk_sizes):
                dur = span * c / total
                self.tracer.span(
                    "prefill-chunk", "dispatch", track, off, dur,
                    args={"kind": "prefill-chunk", "rid": req.rid,
                          "slot": req.slot, "start": pos, "rows": c,
                          "prefix_hit_tokens": start0 if i == 0 else 0,
                          "host_syncs": 1 if i == len(chunk_sizes) - 1 else 0,
                          "interpolated": len(chunk_sizes) > 1,
                          "odin_energy_mj": self.cost_model.energy_mj(c)},
                    flow=req.rid)
                off += dur
                pos += c
        self._slot_len[req.slot] = ntok
        self._record_writes(req, start0, ntok - start0, self._now())
        if fresh:
            tok = self._first_token(ll, req)
            self._emit(req, tok, self._now())
            pending = tok
        else:
            pending = req.generated[-1]
        self._set_last_tok(req.slot, pending)
        if self.spec_ngram:
            self._seed_hist(req)

    # -------------------------------------------------- mixed dispatch path

    def _reset_slot_pos(self, slot: int, value: int) -> None:
        """Set every cache ``pos`` leaf for ``slot`` (the whole slot reset a
        staged admission needs before its first mixed dispatch)."""
        for _, name, leaf in leaves_with_path(self.caches):
            if name == "pos":
                leaf[..., slot] = value

    def _stage_mixed_admission(self, req: Request,
                               grant: Optional[PrefixGrant] = None) -> None:
        """Admission under mixed dispatch: run the COW fork and shared-prefix
        accounting now, then mark the request mid-prefill — its replay is
        staged through fused mixed dispatches, chunk rows at a time."""
        start0 = self._apply_grant(grant)
        req.prefilling = True
        req.prefill_pos = start0
        self._slot_len[req.slot] = start0
        self._reset_slot_pos(req.slot, start0)
        if self.tracer.enabled:
            self.tracer.flow_event("t", "request",
                                   self._slot_track(req.slot), req.rid)

    def _dispatch_mixed(self) -> None:
        """ONE fused dispatch over both populations: decode slots at
        ``q_len = 1`` plus mid-prefill slots at ``q_len ≤ chunk``, packed by
        ``Scheduler.pack_mixed`` under the ``mixed_budget`` row budget.  The
        tile width snaps to a power of two, as in the JAX engine."""
        decode, parts = self.sched.pack_mixed(self.mixed_budget, self.chunk)
        if not decode and not parts:
            return
        q_max = max([1] + [c for _, _, c in parts])
        Q = 1 << (q_max - 1).bit_length()
        tok = np.zeros((self.slots, Q), np.int32)
        q_lens = np.zeros(self.slots, np.int32)
        active = np.zeros(self.slots, bool)
        dm = np.zeros(self.slots, bool)
        for r in decode:
            active[r.slot] = True
            dm[r.slot] = True
            q_lens[r.slot] = 1
            # the pending token is host-resident in the stream
            tok[r.slot, -1] = int(np.ravel(r.generated[-1])[0])
        for r, start, c in parts:
            active[r.slot] = True
            q_lens[r.slot] = c
            tok[r.slot, Q - c:] = np.asarray(r.replay_tokens(), np.int32)[start:start + c]
        t0 = self._now()
        tables = self._refresh_tables()
        dm_dev = self._dev(dm)
        with self._annotate("mixed"):
            nxt, last_logits, self.caches = self._mixed(
                self.params, self.caches, self._dev(tok), self._dev(self._slot_len),
                self._dev(q_lens), dm_dev, self._dev(active), tables,
                self._generator(self.stats.decode_steps), self.temperature)
            host = nxt.cpu().numpy()                 # syncs the step
            ll_host = last_logits.float().cpu().numpy() if parts else None
        wall = self._now() - t0
        dec_rows = len(decode)
        pre_rows = sum(c for _, _, c in parts)
        rows = dec_rows + pre_rows
        self.stats.decode_time += wall * dec_rows / rows
        self.stats.prefill_time += wall * pre_rows / rows
        self.metrics.observe("dispatch_mixed_s", wall)
        self.stats.dispatches += 1
        self.stats.host_syncs += 1
        self.stats.mixed_dispatches += 1
        self.stats.mixed_decode_rows += dec_rows
        self.stats.mixed_prefill_rows += pre_rows
        if self.tracer.enabled:
            self.tracer.span(
                "mixed", "dispatch", "dispatch", t0, wall,
                args={"kind": "mixed", "q_tile": Q,
                      "slots_active": int(active.sum()),
                      "decode_rows": dec_rows, "prefill_rows": pre_rows,
                      "tokens": dec_rows, "rows": rows, "host_syncs": 1,
                      "odin_energy_mj": self.cost_model.energy_mj(rows)})
        now = self._now()
        if decode:
            # the decode sampling schedule only advances when decode rows
            # rode along
            self.stats.decode_steps += 1
            self.stats.decode_dispatches += 1
            self.stats.active_slot_steps += dec_rows
            self.stats.slot_steps += self.slots
            self._last_tok = torch.where(dm_dev[:, None], nxt, self._last_tok)
            self._shift_hist(nxt, dm_dev)
        for r in decode:
            self._record_writes(r, int(self._slot_len[r.slot]), 1, now)
            self._slot_len[r.slot] += 1
            self.stats.decode_tokens += 1
            self._emit(r, host[r.slot, 0], now)
            if r.done:
                self._complete(r, now)
        for r, start, c in parts:
            self._record_writes(r, start, c, now)
            r.prefill_pos = start + c
            self._slot_len[r.slot] = r.prefill_pos
            self.stats.prefill_tokens += c
            r.n_prefill_tokens += c
            if r.prefill_pos < r.cached_len:
                continue                            # more chunks to stage
            self.sched.finish_prefill(r)
            if r.n_generated == 0:
                tok1 = self._first_token(ll_host[r.slot:r.slot + 1], r)
                self._emit(r, tok1, now)
                pending = tok1
            else:
                pending = r.generated[-1]
            self._set_last_tok(r.slot, pending)
            if self.spec_ngram:
                self._seed_hist(r)
            if r.done:
                self._complete(r, now)

    def step(self) -> bool:
        """One engine iteration; returns True while work remains."""
        now = self._now()
        if self._watched:
            self._expire(now)
        nan_ev = None
        if self.fault_plan is not None:
            nan_ev = self._apply_faults(now)
            now = self._now()              # clock skew may have moved it
        # pending stuck-at blocks are swept even with reliability off:
        # fault containment is not optional
        if self._pending_bad or self.reliability is not None:
            self._reliability_sweep(now)
        plan = self.sched.plan(now)

        trace = self.tracer.enabled
        for req, mode, swap_ids, old_slot, dev_ids in plan.preempt:
            if mode == "swap":
                t0 = self._now() if trace else 0.0
                try:
                    req.ticket = self.store.swap_out(
                        self.caches, old_slot, swap_ids, req.cached_len,
                        dev_ids, skip=len(req.kept_blocks))
                except SwapCopyError:
                    self.stats.swap_faults += 1
                    self.sched.fail_swap_out(req)
                    if trace:
                        self.tracer.instant(
                            "swap-fault", "faults", self._slot_track(old_slot),
                            args={"rid": req.rid, "direction": "out"},
                            flow=req.rid)
                    continue
                self.stats.preempt_swap += 1
                self.stats.swap_skipped_blocks += len(req.kept_blocks)
                if trace:
                    track = self._slot_track(old_slot)
                    self.tracer.span(
                        "swap-copy", "dispatch", track, t0, self._now() - t0,
                        args={"kind": "swap-copy", "direction": "out",
                              "rid": req.rid,
                              "blocks": len(swap_ids) - len(req.kept_blocks),
                              "skipped_blocks": len(req.kept_blocks)},
                        flow=req.rid)
                    self.tracer.flow_event("t", "request", track, req.rid, ts=t0)
            else:
                self.stats.preempt_recompute += 1
                if trace:
                    self.tracer.flow_event("t", "request",
                                           self._slot_track(old_slot), req.rid)
        for req in plan.resume:
            t0 = self._now() if trace else 0.0
            n_swap = len(req.ticket.block_ids)
            try:
                self.caches = self.store.swap_in(self.caches, req.slot,
                                                 req.ticket, req.block_table)
            except SwapCopyError:
                self.stats.swap_faults += 1
                slot = req.slot
                self.sched.fail_resume(req)
                if trace:
                    self.tracer.instant(
                        "swap-fault", "faults", self._slot_track(slot),
                        args={"rid": req.rid, "direction": "in"},
                        flow=req.rid)
                continue
            skip = req.ticket.skip_blocks
            nbl = min(len(req.ticket.block_ids), len(req.block_table) - skip)
            if nbl > 0:
                self.pool.record_writes(
                    [(b, self.block_size)
                     for b in req.block_table[skip:skip + nbl]], self._now())
                self.stats.pool_writes = self.pool.total_writes
            self.store.pool.free(req.ticket.block_ids)
            req.ticket = None
            self._slot_len[req.slot] = req.cached_len
            self._set_last_tok(req.slot, req.generated[-1])
            if self.spec_ngram:
                self._seed_hist(req)
            if trace:
                track = self._slot_track(req.slot)
                self.tracer.span(
                    "swap-copy", "dispatch", track, t0, self._now() - t0,
                    args={"kind": "swap-copy", "direction": "in",
                          "rid": req.rid, "blocks": n_swap},
                    flow=req.rid)
                self.tracer.flow_event("t", "request", track, req.rid, ts=t0)
        for req in plan.admit:
            if self.mixed:
                self._stage_mixed_admission(req, plan.grants.get(req.rid))
            else:
                self._prefill_request(req, now, plan.grants.get(req.rid))

        # requests may finish straight out of prefill (max_new == 1)
        for req in list(self.sched.running.values()):
            if req.done:
                self._complete(req, self._now())

        held = set()
        for r in self.sched.running.values():
            held.update(r.block_table)
        self.stats.table_block_steps += len(held)
        self.stats.pool_steps += 1
        if trace:
            self.tracer.counter("kv blocks", "pool",
                                {"referenced": len(held),
                                 "used": self.pool.used_blocks,
                                 "free": self.pool.free_blocks})

        # mid-prefill (staged) slots are excluded from every decode path
        active_slots = sorted(
            s for s, r in self.sched.running.items() if not r.prefilling)
        mixed_pending = self.mixed and any(
            r.prefilling for r in self.sched.running.values())
        spec_k = self.spec_ngram
        max_h = self.horizon
        if self.degrade is not None:
            spec_k = self.degrade.spec_k(spec_k)
            max_h = self.degrade.horizon_cap(max_h)
        if nan_ev is not None and not active_slots:
            self.fault_plan.record(nan_ev, "skipped-idle")
        if active_slots and nan_ev is not None:
            # a poisoned step runs the guarded single step so the NaN is
            # quarantined per slot; greedy streams are horizon-invariant, so
            # unfaulted co-batched slots keep their streams.  Mid-prefill
            # slots sit this step out (the guard has no mixed tile).
            self._decode_guarded_step(active_slots, nan_ev)
        elif mixed_pending:
            self._dispatch_mixed()
        elif active_slots:
            if spec_k:
                # speculation always rides the fused loop (h == 1 is one
                # draft→verify→accept step); grant 0 ⇒ the pool cannot cover
                # the worst-case K+1-row write span — plain single step
                h = self.sched.grant_horizon(max_h, now, self._est_step_time(),
                                             spec_k=spec_k)
                if h >= 1:
                    self._decode_spec_steps(active_slots, h)
                else:
                    self._decode_single_step(active_slots)
            elif self.spec_ngram:
                # speculation shed by the degradation ladder: plain single
                # steps keep the n-gram history aligned for the restore
                self._decode_single_step(active_slots)
            else:
                h = 1
                if max_h > 1:
                    h = self.sched.grant_horizon(max_h, now, self._est_step_time())
                if h > 1:
                    self._decode_horizon_steps(active_slots, h)
                else:
                    self._decode_single_step(active_slots)
        self.stats.steps += 1
        if self.degrade is not None:
            self._observe_degrade(self._now())
        self.metrics.maybe_roll(self._now(), self._counter_snapshot())
        return self.sched.has_work

    def _decode_single_step(self, active_slots: List[int]) -> None:
        """One ``[slots, 1]`` decode dispatch (the horizon=1 parity baseline)."""
        trace = self.tracer.enabled
        t0 = self._now()
        active = np.zeros(self.slots, bool)
        active[active_slots] = True
        tables = self._refresh_tables()
        active_dev = self._dev(active)
        with self._annotate("decode"):
            nxt, self.caches = self._decode(
                self.params, self.caches, self._last_tok,
                self._dev(self._slot_len), active_dev, tables,
                self._generator(self.stats.decode_steps), self.temperature)
            host = nxt.cpu().numpy()                 # syncs the step
        wall = self._now() - t0
        self.stats.decode_time += wall
        self.metrics.observe("dispatch_decode_s", wall)
        if trace:
            rows = len(active_slots)
            self.tracer.span(
                "decode", "dispatch", "dispatch", t0, wall,
                args={"kind": "decode", "h": 1, "spec_k": 0,
                      "slots_active": rows, "tokens": rows, "rows": rows,
                      "host_syncs": 1,
                      "odin_energy_mj": self.cost_model.energy_mj(rows)})
        self.stats.decode_steps += 1
        self.stats.dispatches += 1
        self.stats.decode_dispatches += 1
        self.stats.host_syncs += 1
        self.stats.active_slot_steps += len(active_slots)
        self.stats.slot_steps += self.slots
        self._last_tok = nxt
        self._shift_hist(nxt, active_dev)
        now = self._now()
        for s in active_slots:
            req = self.sched.running[s]
            self._record_writes(req, int(self._slot_len[s]), 1, now)
            self._slot_len[s] += 1
            self.stats.decode_tokens += 1
            self._emit(req, host[s, 0], now)
            if req.done:
                self._complete(req, now)

    def _decode_guarded_step(self, active_slots: List[int], ev) -> None:
        """One guarded ``[slots, 1]`` dispatch with an injected NaN poison.

        The poison corrupts exactly one slot's logits after the forward (a
        resistance excursion flips the readout, not the programmed weights).
        The guard fails that request; every other slot samples from untouched
        logits with the plain step's noise schedule, so unfaulted co-batched
        greedy streams equal a fault-free run's."""
        trace = self.tracer.enabled
        t0 = self._now()
        active = np.zeros(self.slots, bool)
        active[active_slots] = True
        poison = np.zeros(self.slots, bool)
        target = active_slots[ev.slot % len(active_slots)]
        poison[target] = True
        self.fault_plan.record(ev, "poisoned", slot=target,
                               rid=self.sched.running[target].rid)
        tables = self._refresh_tables()
        active_dev = self._dev(active)
        with self._annotate("decode"):
            nxt, bad, self.caches = self._guarded(
                self.params, self.caches, self._last_tok,
                self._dev(self._slot_len), active_dev, tables,
                self._generator(self.stats.decode_steps), self.temperature,
                self._dev(poison))
            host = nxt.cpu().numpy()                 # syncs the step
            badh = bad.cpu().numpy()
        wall = self._now() - t0
        self.stats.decode_time += wall
        self.metrics.observe("dispatch_decode_s", wall)
        if trace:
            rows = len(active_slots)
            self.tracer.span(
                "decode", "dispatch", "dispatch", t0, wall,
                args={"kind": "decode", "h": 1, "spec_k": 0, "guarded": True,
                      "slots_active": rows, "tokens": rows, "rows": rows,
                      "host_syncs": 1,
                      "odin_energy_mj": self.cost_model.energy_mj(rows)})
        self.stats.decode_steps += 1
        self.stats.dispatches += 1
        self.stats.decode_dispatches += 1
        self.stats.host_syncs += 1
        self.stats.active_slot_steps += len(active_slots)
        self.stats.slot_steps += self.slots
        self._last_tok = nxt
        self._shift_hist(nxt, active_dev)
        now = self._now()
        for s in active_slots:
            req = self.sched.running[s]
            # the forward wrote this slot's KV row whether or not its readout
            # was poisoned: wear is physical, bill it either way
            self._record_writes(req, int(self._slot_len[s]), 1, now)
            if badh[s]:
                # quarantine: only the poisoned request fails; its token
                # never enters a stream and the slot is re-admittable
                self.stats.nan_quarantined += 1
                self._finalize(req, RequestState.FAILED, "nan_logits", now)
                continue
            self._slot_len[s] += 1
            self.stats.decode_tokens += 1
            self._emit(req, host[s, 0], now)
            if req.done:
                self._complete(req, now)

    def _decode_horizon_steps(self, active_slots: List[int], h: int) -> None:
        """One dispatch generating up to ``h`` tokens per slot, with one host
        sync.  The scheduler has pre-extended every running table for ``h``
        rows; slots freeze on the device at EOS / budget exhaustion and the
        returned ``counts`` say which prefix of each slot's row is real.
        Per-token timestamps interpolate over the dispatch's span of the
        engine clock."""
        t_before = self._now()
        active = np.zeros(self.slots, bool)
        active[active_slots] = True
        rem = np.zeros(self.slots, np.int32)
        for s in active_slots:
            rem[s] = self.sched.running[s].remaining
        tables = self._refresh_tables()
        step0 = self.stats.decode_steps
        gens = (None if self.temperature <= 0
                else [self._generator(step0 + i) for i in range(h)])
        with self._annotate("horizon"):
            block, counts, last, self.caches = self._fused_fn(h, 0)(
                self.params, self.caches, self._last_tok,
                self._dev(self._slot_len), self._dev(active), self._dev(rem),
                tables, gens, self.temperature,
                -1 if self.eos_id is None else self.eos_id)
            block, counts = block.cpu().numpy(), counts.cpu().numpy()  # ONE sync
        wall = self._now() - t_before
        self.stats.decode_time += wall
        self.metrics.observe("dispatch_decode_s", wall)
        if self.tracer.enabled:
            emitted = int(counts.sum())
            self.tracer.span(
                "horizon", "dispatch", "dispatch", t_before, wall,
                args={"kind": "horizon", "h": h, "spec_k": 0,
                      "slots_active": len(active_slots), "tokens": emitted,
                      "rows": emitted, "host_syncs": 1,
                      "odin_energy_mj": self.cost_model.energy_mj(emitted)})
        self.stats.decode_steps += h
        self.stats.dispatches += 1
        self.stats.decode_dispatches += 1
        self.stats.host_syncs += 1
        self.stats.active_slot_steps += int(counts.sum())
        self.stats.slot_steps += self.slots * h
        self._last_tok = last
        now_w = self._now()
        for s in active_slots:
            self._record_writes(self.sched.running[s],
                                int(self._slot_len[s]), int(counts[s]), now_w)
        span = wall
        for hh in range(h):                      # step-major: matches h=1 order
            t_h = t_before + (hh + 1) * span / h
            for s in active_slots:
                if hh < counts[s]:
                    self._slot_len[s] += 1
                    self.stats.decode_tokens += 1
                    self._emit(self.sched.running[s], block[s, hh], t_h)
        for s in active_slots:
            req = self.sched.running[s]
            if req.done:
                self._complete(req, t_before + int(counts[s]) * span / h)

    def _decode_spec_steps(self, active_slots: List[int], h: int) -> None:
        """One dispatch of ``h`` draft→verify→accept inner steps, one host
        sync.

        Each inner step emits 1..K+1 tokens per live slot (the accepted
        draft prefix plus the bonus token); ``counts[s, hh]`` tells the host
        which prefix of ``block[s, hh]`` is real.  Timestamps interpolate
        over the dispatch's engine-clock span per inner step, and within a
        step across its accepted run."""
        K = self.spec_ngram
        t_before = self._now()
        active = np.zeros(self.slots, bool)
        active[active_slots] = True
        rem = np.zeros(self.slots, np.int32)
        for s in active_slots:
            rem[s] = self.sched.running[s].remaining
        tables = self._refresh_tables()
        with self._annotate("spec-horizon"):
            block, counts, last, hist, self.caches = self._fused_fn(h, K)(
                self.params, self.caches, self._last_tok,
                self._dev(self._slot_len), self._dev(active), self._dev(rem),
                self._hist, tables, -1 if self.eos_id is None else self.eos_id)
            block, counts = block.cpu().numpy(), counts.cpu().numpy()  # ONE sync
        self._last_tok = last
        self._hist = hist
        wall = self._now() - t_before
        self.stats.decode_time += wall
        self.metrics.observe("dispatch_decode_s", wall)
        self.stats.decode_steps += h
        self.stats.dispatches += 1
        self.stats.decode_dispatches += 1
        self.stats.host_syncs += 1
        live = counts > 0                                  # [slots, h]
        self.stats.active_slot_steps += int(live.sum())
        self.stats.slot_steps += self.slots * h
        self.stats.spec_drafted += K * int(live.sum())
        self.stats.spec_accepted += int((counts - live).sum())
        # every live inner step verified a K+1-row forward; rows beyond the
        # emitted run are rejected drafts, billed as verify overhead both
        # fleet-wide and on the request that incurred them
        emitted = int(counts.sum())
        rows = (K + 1) * int(live.sum())
        self.stats.spec_overhead_rows += rows - emitted
        for s in active_slots:
            s_over = int(((K + 1) * live[s] - counts[s]).sum())
            if s_over:
                self.sched.running[s].spec_overhead_rows += s_over
        if self.tracer.enabled:
            self.tracer.span(
                "spec-horizon", "dispatch", "dispatch", t_before, wall,
                args={"kind": "spec-horizon", "h": h, "spec_k": K,
                      "slots_active": len(active_slots), "tokens": emitted,
                      "drafted": K * int(live.sum()),
                      "accepted": int((counts - live).sum()),
                      "rows": rows, "overhead_rows": rows - emitted,
                      "host_syncs": 1,
                      "odin_energy_mj": self.cost_model.energy_mj(rows)})
        now_w = self._now()
        for s in active_slots:
            # endurance mirror: every live inner step wrote a K+1-row verify
            # tile at the slot's running position (rejected rows were
            # physically written before rollback), and the position advanced
            # by the accepted count
            pos = int(self._slot_len[s])
            for hh in range(h):
                if live[s, hh]:
                    self._record_writes(self.sched.running[s], pos, K + 1, now_w)
                    pos += int(counts[s, hh])
        span = wall
        last_t = {}
        for hh in range(h):                      # step-major: matches h=1 order
            for s in active_slots:
                m = int(counts[s, hh])
                for j in range(m):
                    t_tok = t_before + (hh + (j + 1) / m) * span / h
                    self._slot_len[s] += 1
                    self.stats.decode_tokens += 1
                    self._emit(self.sched.running[s], block[s, hh, j], t_tok)
                    last_t[s] = t_tok
        for s in active_slots:
            req = self.sched.running[s]
            if req.done:
                self._complete(req, last_t.get(s, t_before + span))

    def _fused_fn(self, h: int, k: int) -> Callable:
        """LRU cache of fused decode functions, keyed ``(h, spec K)``."""
        key = (h, k)
        fn = self._fused.get(key)
        if fn is None:
            fn = (make_serving_spec_horizon(self.cfg, h, k, n=self._spec_n) if k
                  else make_serving_decode_horizon(self.cfg, h, top_k=self.top_k))
            self._fused[key] = fn
            if len(self._fused) > self.jit_cache:
                self._fused.popitem(last=False)
                self.stats.jit_evictions += 1
        else:
            self._fused.move_to_end(key)
        return fn

    def _est_step_time(self) -> float:
        """Measured seconds per decode token step (0 until the first step)."""
        return (self.stats.decode_time / self.stats.decode_steps
                if self.stats.decode_steps else 0.0)

    def run(self, requests: Sequence[Request] = (), max_steps: int = 100_000) -> Dict:
        """Submit ``requests``, drive the loop until drained, return the
        metrics summary (per-request records + aggregates)."""
        for req in requests:
            self.submit(req)
        self._now()                                       # start the clock
        steps = idle = 0
        while self.sched.has_work:
            busy = bool(self.sched.running)
            self.step()
            if busy or self.sched.running:
                steps += 1
                idle = 0
                if steps > max_steps:
                    raise EngineStallError(
                        f"engine exceeded {max_steps} steps",
                        summary=self.summary())
            else:
                idle += 1
                if idle > max_steps:
                    raise EngineStallError(
                        f"engine idle for {max_steps} iterations — is the "
                        "clock advancing toward the next arrival?",
                        summary=self.summary())
                nxt = self.sched.next_arrival()
                if nxt is not None and nxt > self._now():
                    time.sleep(max(0.0, min(0.05, nxt - self._now())))
        return self.summary()

    def summary(self) -> Dict:
        done = self._all_requests()
        self._update_wear_gauges()
        self.stats.retired_blocks = len(self.pool.retired)
        self.metrics.flush(self._now(), self._counter_snapshot())
        out = summarize(done, self.stats, self.cost_model,
                        registry=self.metrics)
        if self.degrade is not None:
            out["degradation"].update(self.degrade.snapshot(self._now()))
        if self.fault_plan is not None:
            out["fault_plan"] = self.fault_plan.snapshot()
        return out

    def _all_requests(self) -> List[Request]:
        seen = {r.rid: r for _, _, r in self.sched.waiting}
        for r in list(self.sched.swapped) + list(self.sched.running.values()):
            seen[r.rid] = r
        for r in self._done:
            seen[r.rid] = r
        return list(seen.values())
