"""Synthetic open-loop request generators for serving scenarios.

Arrivals follow a Poisson process (optionally bursty: ``burst`` requests per
arrival event); prompt and generation lengths draw from discrete buckets.
Bucketed lengths are deliberate: prefill chunk shapes stay bounded (each
distinct chunk length traces one executable) while still exercising the
mixed-length behavior that separates continuous batching from the static
loop — short-generation requests retire early and their slots re-admit.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.serving.scheduler import Request

__all__ = ["WorkloadSpec", "SCENARIOS", "poisson_arrivals", "make_requests"]


@dataclass(frozen=True)
class WorkloadSpec:
    n_requests: int = 16
    rate: float = 50.0                    # arrival events per second
    burst: int = 1                        # requests per arrival event
    prompt_buckets: Tuple[int, ...] = (16, 32)
    prompt_weights: Optional[Tuple[float, ...]] = None
    gen_buckets: Tuple[int, ...] = (8, 32)
    gen_weights: Optional[Tuple[float, ...]] = None
    # shared system prompt: every request's prompt starts with the same
    # ``shared_prefix`` tokens (drawn once per seed), split over
    # ``share_groups`` distinct system prompts round-robin — the workload
    # prefix sharing dedups.  ``prompt_buckets`` then sizes the unique tail.
    shared_prefix: int = 0
    share_groups: int = 1
    # repetition-heavy prompts: >0 tiles a per-request random pattern of this
    # period to the bucket length (structured/templated traffic — the
    # workload n-gram speculation feeds on; greedy continuations of periodic
    # prompts fall into cycles the draft match predicts)
    pattern_period: int = 0
    # failure-semantics schedules (all off by default — and drawn AFTER the
    # length/arrival draws, so enabling them never perturbs the token streams
    # an existing seed produces): per-request deadlines sampled from buckets
    # of seconds-after-arrival, a queue-admission timeout, and client
    # cancellations — each request cancels with prob ``cancel_rate`` at
    # ``arrival + cancel_after * deadline`` (or ``cancel_after`` seconds when
    # no deadline is set)
    deadline_buckets: Optional[Tuple[float, ...]] = None
    deadline_weights: Optional[Tuple[float, ...]] = None
    queue_timeout: Optional[float] = None
    cancel_rate: float = 0.0
    cancel_after: float = 0.5
    # multi-tenant traffic: >0 assigns tenant ids "t0".."t{n-1}" round-robin
    # by request index.  The assignment consumes NO rng draws, so enabling
    # tenants never perturbs the token streams an existing seed produces.
    n_tenants: int = 0


# Scenario presets (lengths are smoke-scale; scale up for full configs).
SCENARIOS: Dict[str, WorkloadSpec] = {
    # uniform lengths, steady arrivals — the static loop's best case
    "steady": WorkloadSpec(prompt_buckets=(32,), gen_buckets=(16,)),
    # mixed generation lengths — finished slots must re-admit to keep busy
    "mixed": WorkloadSpec(prompt_buckets=(16, 32), gen_buckets=(4, 16, 48),
                          gen_weights=(0.4, 0.35, 0.25)),
    # bursty arrivals of long-tail requests — exercises queueing + preemption
    "bursty": WorkloadSpec(burst=4, rate=10.0, prompt_buckets=(16, 48),
                           gen_buckets=(8, 64), gen_weights=(0.7, 0.3)),
    # shared system prompt + unique user tails — the prefix-sharing workload
    "shared": WorkloadSpec(shared_prefix=96, prompt_buckets=(8, 16),
                           gen_buckets=(8, 16)),
    # periodic prompts + long generations — repetition-heavy traffic where
    # greedy continuations cycle and n-gram speculation accepts deep drafts
    "repetitive": WorkloadSpec(pattern_period=8, prompt_buckets=(32,),
                               gen_buckets=(160,)),
    # impatient bursty clients: tight bursts, deadlines of the same order as
    # a request's service time, and a cancellation stream — the robustness
    # workload (queue expiry, mid-run aborts, degradation under pressure)
    "flaky": WorkloadSpec(burst=4, rate=20.0, prompt_buckets=(16, 48),
                          gen_buckets=(8, 64), gen_weights=(0.7, 0.3),
                          deadline_buckets=(0.5, 2.0, 8.0),
                          deadline_weights=(0.3, 0.4, 0.3),
                          queue_timeout=4.0, cancel_rate=0.15),
}


def poisson_arrivals(rng: np.random.Generator, n: int, rate: float,
                     burst: int = 1) -> np.ndarray:
    """[n] arrival offsets (seconds): Poisson events of ``burst`` requests."""
    n_events = -(-n // burst)
    gaps = rng.exponential(1.0 / max(rate, 1e-9), n_events)
    times = np.cumsum(gaps)
    return np.repeat(times, burst)[:n]


def _draw(rng, buckets, weights, n):
    p = None if weights is None else np.asarray(weights) / np.sum(weights)
    return rng.choice(np.asarray(buckets), size=n, p=p)


def make_requests(cfg: ModelConfig, spec: WorkloadSpec, seed: int = 0,
                  start_rid: int = 0) -> List[Request]:
    """Build ``spec.n_requests`` synthetic requests for ``cfg``.

    With ``spec.shared_prefix > 0``, request ``i`` prepends system prompt
    ``i % spec.share_groups`` (each ``shared_prefix`` tokens, drawn once) to
    its unique ``prompt_buckets``-sized tail.
    """
    rng = np.random.default_rng(seed)
    arrivals = poisson_arrivals(rng, spec.n_requests, spec.rate, spec.burst)
    plens = _draw(rng, spec.prompt_buckets, spec.prompt_weights, spec.n_requests)
    gens = _draw(rng, spec.gen_buckets, spec.gen_weights, spec.n_requests)
    lead = lambda n: (cfg.n_codebooks, n) if cfg.n_codebooks > 1 else (n,)
    systems = [rng.integers(0, cfg.vocab, size=lead(spec.shared_prefix),
                            dtype=np.int32)
               for _ in range(spec.share_groups)] if spec.shared_prefix else []
    out = []
    for i in range(spec.n_requests):
        if spec.pattern_period:
            pat = rng.integers(0, cfg.vocab, size=lead(spec.pattern_period),
                               dtype=np.int32)
            reps = -(-int(plens[i]) // spec.pattern_period)
            tiles = (1,) * (pat.ndim - 1) + (reps,)
            prompt = np.tile(pat, tiles)[..., :int(plens[i])]
        else:
            prompt = rng.integers(0, cfg.vocab, size=lead(int(plens[i])),
                                  dtype=np.int32)
        if systems:
            prompt = np.concatenate(
                [systems[i % spec.share_groups], prompt], axis=-1)
        out.append(Request(rid=start_rid + i, prompt=prompt,
                           max_new=int(gens[i]), arrival=float(arrivals[i])))
    if spec.n_tenants:
        # round-robin by index, no rng: seeds stay byte-identical
        for i, req in enumerate(out):
            req.tenant = f"t{i % spec.n_tenants}"
    # failure-semantics draws come last: legacy seeds consume an identical
    # rng stream, so streams stay byte-identical with these features off
    if spec.deadline_buckets:
        dls = _draw(rng, spec.deadline_buckets, spec.deadline_weights,
                    spec.n_requests)
        for req, d in zip(out, dls):
            req.deadline = req.arrival + float(d)
    if spec.queue_timeout is not None:
        for req in out:
            req.queue_timeout = float(spec.queue_timeout)
    if spec.cancel_rate > 0.0:
        flips = rng.random(spec.n_requests) < spec.cancel_rate
        for req, flip in zip(out, flips):
            if flip:
                horizon = ((req.deadline - req.arrival) * spec.cancel_after
                           if req.deadline is not None else spec.cancel_after)
                req.cancel_at = req.arrival + float(horizon)
    return out
