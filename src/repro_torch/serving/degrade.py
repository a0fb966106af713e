"""Graceful degradation: shed load along a traced ladder, restore in reverse.

The :class:`DegradationController` watches the engine's live observables
each step — pool occupancy, arrived queue depth, preemption churn, and the
speculative ``accept_rate`` — and walks a five-level ladder:

====  ================  ====================================================
lvl   name              effect
====  ================  ====================================================
0     ``normal``        full service
1     ``spec_off``      speculation disabled (K→0): verify rows are the
                        first ballast overboard — they buy latency with
                        extra KV rows and pool pressure
2     ``horizon_min``   horizon grants shrunk to ``min_horizon`` so slots
                        re-plan (and free) at a finer grain
3     ``prefix_release``  prefix-cache retention released: resident chains
                        no longer pin blocks, reclaimable blocks are freed
4     ``admit_deny``    admissions denied with a structured retry-after
                        (queued requests wait; their queue_timeout bounds
                        the wait)
====  ================  ====================================================

Escalation needs ``up_steps`` consecutive unhealthy observations; recovery
needs ``down_steps`` consecutive healthy ones (hysteresis, so the ladder
does not thrash on the boundary).  One level per transition, each traced
as a ``degrade``/``restore`` instant on the scheduler track.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .trace import NULL_TRACER

__all__ = ["DegradeConfig", "DegradationController", "DEGRADE_LEVELS"]

DEGRADE_LEVELS = ("normal", "spec_off", "horizon_min", "prefix_release",
                  "admit_deny")


@dataclass(frozen=True)
class DegradeConfig:
    """Thresholds and hysteresis for the degradation ladder.

    ``pool_hi``/``pool_lo`` bound pool occupancy (used/total blocks);
    ``queue_hi``/``queue_lo`` bound the *arrived* waiting-queue depth;
    ``churn_hi`` is preemptions-per-observation that count as pressure;
    ``accept_lo`` treats a draining speculative accept rate under mild
    pool pressure as pressure too (verify rows are pure overhead then);
    ``retired_hi`` is the PCRAM bad-block fraction (retired/total) above
    which sustained capacity loss counts as pressure while the surviving
    pool is actually loaded — a retirement storm walks the ladder to
    admission denial instead of crashing into exhaustion.
    """
    pool_hi: float = 0.85
    pool_lo: float = 0.55
    queue_hi: int = 3
    queue_lo: int = 0
    churn_hi: int = 1
    accept_lo: float = 0.25
    retired_hi: float = 0.25
    up_steps: int = 2
    down_steps: int = 6
    min_horizon: int = 2
    retry_after_steps: float = 8.0


class DegradationController:
    def __init__(self, cfg: Optional[DegradeConfig] = None, tracer=None):
        self.cfg = cfg or DegradeConfig()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.level = 0
        self.transitions = 0
        self._hot = 0
        self._cool = 0
        self._est_step_time = 0.0
        # transition log for snapshot(): bounded so a thrash-prone config
        # cannot grow the summary without limit (oldest entries drop)
        self.history: list = []
        self._history_cap = 64

    @property
    def name(self) -> str:
        return DEGRADE_LEVELS[self.level]

    def _log_transition(self, now: float, direction: str) -> None:
        self.history.append({"t": now, "level": self.level,
                             "name": self.name, "dir": direction})
        if len(self.history) > self._history_cap:
            del self.history[0]

    def observe(self, now: float, *, pool_frac: float, queue_depth: int,
                churn: int, accept_rate: Optional[float] = None,
                est_step_time: float = 0.0, active: int = 0,
                retired_frac: float = 0.0) -> int:
        """Feed one step's observables; returns the (possibly new) level.

        ``accept_rate`` is None when no drafting happened this window.
        ``active`` is the running-slot count: queue depth only counts as
        pressure while slots are actually busy, and an *idle* engine always
        reads as calm no matter how deep its queue — otherwise admission
        denial would deadlock (deny ⇒ nothing runs ⇒ queue never drains ⇒
        deny forever).  The restore path is the liveness guarantee.
        ``retired_frac`` is the PCRAM bad-block fraction — sustained
        retirement counts as pressure only while the surviving pool carries
        real load (``pool_frac >= pool_lo``), so a mostly-idle engine with
        old scars stays calm and can still restore.
        """
        c = self.cfg
        self._est_step_time = est_step_time
        pressure = (pool_frac >= c.pool_hi
                    or (queue_depth >= c.queue_hi and active > 0)
                    or churn > c.churn_hi
                    or (accept_rate is not None and accept_rate < c.accept_lo
                        and pool_frac >= c.pool_lo)
                    or (retired_frac >= c.retired_hi
                        and pool_frac >= c.pool_lo))
        calm = (pool_frac <= c.pool_lo and churn == 0
                and (queue_depth <= c.queue_lo or active == 0))
        if pressure:
            self._hot += 1
            self._cool = 0
            if self._hot >= c.up_steps and self.level < len(DEGRADE_LEVELS) - 1:
                self.level += 1
                self.transitions += 1
                self._hot = 0
                self._log_transition(now, "up")
                if self.tracer.enabled:
                    self.tracer.instant(
                        "degrade", "scheduler", "scheduler", ts=now,
                        args={"level": self.level, "name": self.name,
                              "pool_frac": round(pool_frac, 4),
                              "queue_depth": queue_depth, "churn": churn})
        elif calm:
            self._cool += 1
            self._hot = 0
            if self._cool >= c.down_steps and self.level > 0:
                self.level -= 1
                self.transitions += 1
                self._cool = 0
                self._log_transition(now, "down")
                if self.tracer.enabled:
                    self.tracer.instant(
                        "restore", "scheduler", "scheduler", ts=now,
                        args={"level": self.level, "name": self.name})
        else:
            # neither hot nor cool: decay both streaks (require consecutive)
            self._hot = 0
            self._cool = 0
        return self.level

    # ---- engine-facing knobs -------------------------------------------
    def spec_k(self, k: int) -> int:
        return 0 if self.level >= 1 else k

    def horizon_cap(self, h: int) -> int:
        return min(h, self.cfg.min_horizon) if self.level >= 2 else h

    @property
    def release_prefix(self) -> bool:
        return self.level >= 3

    @property
    def deny_admission(self) -> bool:
        return self.level >= 4

    def retry_after(self, now: float) -> float:
        """Structured backoff hint: when a denied client should retry."""
        step = max(self._est_step_time, 1e-3)
        return now + self.cfg.retry_after_steps * step

    def snapshot(self, now: Optional[float] = None) -> dict:
        """Operator-facing state: level, transition history, and — when
        admissions are currently denied and ``now`` is given — the live
        ``retry_after_s`` hint in *relative* seconds (the same number the
        front door returns to rejected clients), else None."""
        retry = None
        if now is not None and self.deny_admission:
            retry = max(0.0, self.retry_after(now) - now)
        return {"level": self.level, "name": self.name,
                "transitions": self.transitions,
                "history": list(self.history),
                "retry_after_s": retry}
