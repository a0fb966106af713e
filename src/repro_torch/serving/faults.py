"""Seeded fault injection for the serving engine.

ODIN computes inside an imperfect medium — PCRAM drifts, SC rails are
approximate by construction — so the serving stack must treat failure as
an input, not an exception.  A :class:`FaultPlan` is a deterministic,
seeded schedule of fault events at the engine's real seams:

=============  ==============================================================
site           what fires
=============  ==============================================================
``alloc``      the next ``count`` :meth:`BlockPool.alloc` calls return None
               (pool exhaustion between headroom check and extension)
``swap_out``   the next swap-out copy raises :class:`SwapCopyError` before
               touching device state (the ticket is never created)
``swap_in``    the next swap-in copy raises :class:`SwapCopyError` (the
               resumed slot is torn back down to a recompute re-queue)
``nan_logits`` one decode step poisons one slot's logits with NaN — the
               per-slot guard must quarantine exactly that request as
               FAILED while co-batched slots keep bit-identical streams
``clock_skew`` the engine clock jumps by ``skew_s`` (negative jumps are
               clamped by the engine's monotone guard)
``stuck_at``   one PCRAM block (``slot`` modulo the pool size) develops a
               stuck-at cell fault — the reliability sweep must drain and
               retire it before the next dispatch touches it
``wear_exhaustion``
               the ``count`` most-worn live blocks burn through their
               remaining endurance at once — a retirement storm that must
               walk the degradation ladder, never crash the pool
=============  ==============================================================

The plan is pure data (numpy only, no serving imports) so it can be
serialized as a CI artifact (``to_json``/``from_json``) and replayed to
reproduce a falsifying chaos run exactly.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "FAULT_SITES",
    "FaultEvent",
    "FaultPlan",
    "SwapCopyError",
    "EngineStallError",
    "Overloaded",
    "ShuttingDown",
]

FAULT_SITES = ("alloc", "swap_out", "swap_in", "nan_logits", "clock_skew",
               "stuck_at", "wear_exhaustion")


class SwapCopyError(RuntimeError):
    """Injected swap-ticket copy failure (device↔host block copy lost).

    Raised by :class:`~repro_torch.serving.blocks.PagedKVStore` before any cache
    mutation, so the engine can fall back to the recompute path with the
    caches untouched.
    """


class EngineStallError(RuntimeError):
    """The engine exceeded its step/idle budget without draining.

    Carries the partial :meth:`ServingEngine.summary` as ``.summary`` so a
    wedged run still yields its metrics and trace.
    """

    def __init__(self, message: str, summary: Optional[dict] = None):
        super().__init__(message)
        self.summary = summary


class Overloaded(RuntimeError):
    """Typed admission rejection (the HTTP-429 shape).

    Raised by the front door instead of buffering unboundedly: the request
    queue is full, the degradation ladder reached ``admit_deny``, or the
    tenant's token bucket is exhausted.  ``retry_after`` is the structured
    backoff hint in *relative seconds* (None when no estimate exists) and
    ``tenant`` names the quota that rejected, when one did.
    """

    def __init__(self, message: str, retry_after: Optional[float] = None,
                 tenant: Optional[str] = None):
        super().__init__(message)
        self.retry_after = retry_after
        self.tenant = tenant


class ShuttingDown(Overloaded):
    """Typed late-submit rejection while the engine drains (HTTP-503 shape).

    A subclass of :class:`Overloaded` so one except-clause covers both
    rejection shapes; ``retry_after`` is usually None — the process is going
    away, not backing off.
    """


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: ``site`` fires at engine step ``step``.

    ``count`` arms multi-shot sites (alloc/swap counters) and picks how many
    worn blocks ``wear_exhaustion`` burns out; ``slot`` picks the poisoned
    slot for ``nan_logits`` (taken modulo the live slot count at fire time)
    and doubles as the bad-block selector for ``stuck_at`` (modulo the pool
    size); ``skew_s`` is the clock jump for ``clock_skew``.
    """
    site: str
    step: int
    count: int = 1
    slot: int = 0
    skew_s: float = 0.0

    def __post_init__(self):
        if self.site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"expected one of {FAULT_SITES}")
        if self.step < 0 or self.count < 1:
            raise ValueError("FaultEvent needs step >= 0 and count >= 1")


class FaultPlan:
    """A deterministic schedule of :class:`FaultEvent`s keyed by step.

    The engine consumes events via :meth:`events_at` at the top of each
    ``step()`` and records what actually happened with :meth:`record`
    (armed / poisoned rid / skipped), so a replayed plan can be diffed
    against its original firing log.
    """

    def __init__(self, events: Sequence[FaultEvent] = (), seed: int = 0):
        self.events: Tuple[FaultEvent, ...] = tuple(events)
        self.seed = seed
        self.fired: List[dict] = []
        self._by_step: Dict[int, List[FaultEvent]] = {}
        for ev in self.events:
            self._by_step.setdefault(ev.step, []).append(ev)

    def __len__(self) -> int:
        return len(self.events)

    def events_at(self, step: int) -> List[FaultEvent]:
        return self._by_step.get(step, [])

    def record(self, event: FaultEvent, outcome: str, **detail) -> None:
        self.fired.append({"site": event.site, "step": event.step,
                           "outcome": outcome, **detail})

    @classmethod
    def generate(cls, seed: int, n_steps: int = 64, rate: float = 0.15,
                 sites: Sequence[str] = FAULT_SITES,
                 max_skew_s: float = 0.05) -> "FaultPlan":
        """Draw a random plan: each step fires one fault with prob ``rate``,
        site chosen uniformly from ``sites``.  Same seed → same plan."""
        rng = np.random.default_rng(seed)
        events = []
        for step in range(n_steps):
            if rng.random() >= rate:
                continue
            site = sites[int(rng.integers(len(sites)))]
            events.append(FaultEvent(
                site=site, step=step,
                count=int(rng.integers(1, 4)),
                slot=int(rng.integers(0, 64)),
                skew_s=float(rng.uniform(-max_skew_s, max_skew_s))
                if site == "clock_skew" else 0.0))
        return cls(events, seed=seed)

    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed,
            "events": [dataclasses.asdict(ev) for ev in self.events],
            "fired": self.fired,
        }, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        obj = json.loads(text)
        events = [FaultEvent(**{k: v for k, v in ev.items()
                                if k in {f.name for f in
                                         dataclasses.fields(FaultEvent)}})
                  for ev in obj.get("events", [])]
        return cls(events, seed=obj.get("seed", 0))

    def snapshot(self) -> dict:
        """Summary-friendly view: schedule size + what actually fired."""
        return {"seed": self.seed, "n_events": len(self.events),
                "fired": list(self.fired)}
