"""PCRAM reliability layer: endurance budgets, wear stats, scrub policy.

ODIN computes in-situ in phase-change RAM, and PCRAM's defining reliability
constraints — finite write endurance (~1e6–1e9 SET/RESET cycles per cell),
resistance drift of the stored analog state over time, and stuck-at cell
faults — are properties of the *medium*, not of any one workload.  The
device block pool is the "physical PCRAM", so this module
makes those constraints first-class for the serving stack:

* :class:`ReliabilityConfig` — the knob set threaded through
  ``ServingEngine(reliability=...)``: an optional per-block **endurance
  budget** (writes-in-rows before a block is retired), the **wear-leveling**
  allocator policy toggle (min-wear free-list ordering in
  :class:`~repro_torch.serving.blocks.BlockPool`), and the **drift-refresh
  scrubber** rate/deadline (rewrite the oldest-written resident blocks at a
  bounded blocks-per-step rate before their analog state drifts past the
  read margin).

* :func:`wear_gini` — the Gini coefficient of the per-block write
  distribution, the summary statistic the bench uses to show wear-leveling
  *provably narrows* wear vs. the seed LIFO allocator (0 = perfectly even,
  →1 = all writes on one block).

Everything here is pure host-side policy: the accounting lives in
``BlockPool`` (a host mirror of device writes derived from the same
StepPlan/scheduler bookkeeping that already tracks table claims), the
retirement/scrub *mechanism* lives in the engine (block copies through the
existing pool-leaf machinery, billed as a ``scrub`` ODIN energy phase), and
capacity loss feeds the degradation ladder as a new pressure input.  The
stack's signature invariant is preserved by construction: retirement and
scrubbing copy identical bytes and only change *which physical block id*
holds them, so greedy streams are bit-identical with reliability on vs. off.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

__all__ = ["ReliabilityConfig", "wear_gini"]


@dataclass(frozen=True)
class ReliabilityConfig:
    """Knobs for the PCRAM reliability layer.

    endurance_budget
        Per-block write budget in *cache rows written*; a block whose wear
        counter crosses it is drained (contents copied to a fresh block, all
        live tables remapped) and retired from the free list.  None ⇒ blocks
        are immortal (accounting still runs).
    wear_leveling
        Order the pool free list by (wear, age-freed) so allocation always
        picks the least-worn block, ties broken oldest-freed-first.  Off ⇒
        the seed LIFO order.
    scrub_rate
        Drift-refresh bound: at most this many resident blocks rewritten in
        place per engine step.  0 disables the scrubber.
    drift_deadline_s
        A resident block whose last write is older than this is due for a
        drift refresh.  None disables the scrubber regardless of rate.
    """

    endurance_budget: Optional[int] = None
    wear_leveling: bool = True
    scrub_rate: int = 0
    drift_deadline_s: Optional[float] = None

    def __post_init__(self):
        if self.endurance_budget is not None and self.endurance_budget <= 0:
            raise ValueError(f"endurance_budget must be positive, "
                             f"got {self.endurance_budget}")
        if self.scrub_rate < 0:
            raise ValueError(f"scrub_rate must be >= 0, got {self.scrub_rate}")
        if self.drift_deadline_s is not None and self.drift_deadline_s <= 0:
            raise ValueError(f"drift_deadline_s must be positive, "
                             f"got {self.drift_deadline_s}")

    @property
    def scrub_enabled(self) -> bool:
        return self.scrub_rate > 0 and self.drift_deadline_s is not None


def wear_gini(wear) -> float:
    """Gini coefficient of a per-block write distribution.

    0.0 ⇒ perfectly even wear; → 1.0 ⇒ all writes concentrated on one
    block.  An all-zero distribution reads as perfectly even.
    """
    w = np.sort(np.asarray(wear, np.float64))
    n = w.size
    total = w.sum()
    if n == 0 or total <= 0:
        return 0.0
    # G = (2 * sum_i i*w_i) / (n * sum w) - (n + 1) / n  with i in 1..n
    idx = np.arange(1, n + 1, dtype=np.float64)
    return float((2.0 * (idx * w).sum()) / (n * total) - (n + 1.0) / n)
