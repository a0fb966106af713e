"""Serving-engine structured tracing + windowed metrics.

Two instruments, both cheap enough to leave compiled-in:

* :class:`Tracer` — a ring-buffered structured event recorder.  The engine
  emits **dispatch spans** at every compiled-step launch site (prefill-chunk,
  decode, horizon, spec-horizon, swap-copy, cow-copy — each carrying slot
  occupancy, granted horizon, draft length, emitted/accepted token counts and
  its ODIN PIMC energy bill), **request lifecycle events** (queued → admitted
  → prefill → decode → preempt/resume → complete) linked by per-request
  **flow ids** that survive preemption, and **decision events** from the
  scheduler (admission grant/deny with marginal-block accounting,
  ``grant_horizon`` inputs/outputs) and the block pool (alloc/free/fork,
  prefix-cache eviction).  The buffer drops-oldest at capacity and counts the
  drops, so a long run can always be traced at bounded memory.

  Tracing is **off by default**: the module-level :data:`NULL_TRACER` is a
  no-op recorder whose ``enabled`` flag lets every call site skip even the
  argument-dict construction, so the trace-off hot path allocates nothing.

* :class:`StepPhases` — one engine step's host phases (plan, pack, upload,
  enqueue, sync, emit) on the engine clock, written as ``<phase>_s`` fields
  of the step's dispatch span when the tracer records, and each a profiler
  range ``serving/<phase>`` under ``xla_annotations`` while the profiler
  records, so that the spans and the device trace share one timeline.

* :class:`MetricsRegistry` — windowed serving metrics.  Log-bucketed
  streaming histograms (TTFT / TPOT / per-dispatch wall time) plus counter
  deltas are snapshotted every ``window_s`` seconds of engine clock, so a
  long run reports p50/p99 *over time* instead of one end-of-run number.

Export is Chrome trace-event JSON (the ``traceEvents`` array format), loadable
in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``: one track per
engine slot plus scheduler/pool tracks, ``X`` complete events for spans,
``C`` counter series for pool occupancy, and ``s``/``t``/``f`` flow events
following a request across preemptions.  :func:`validate_chrome_trace` is the
schema check CI runs over the benchmark's trace artifact.

Usage::

    from repro_torch.serving import ServingEngine, Tracer

    tracer = Tracer()
    eng = ServingEngine(cfg, slots=4, max_len=96, tracer=tracer)
    eng.run(requests)
    tracer.export("trace.json")          # load in https://ui.perfetto.dev
"""
from __future__ import annotations

import json
import math
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch import obs

__all__ = ["TraceEvent", "Tracer", "NullTracer", "NULL_TRACER",
           "PHASES", "StepPhases",
           "LogHistogram", "MetricsRegistry",
           "chrome_trace", "validate_chrome_trace"]


# --------------------------------------------------------------------- events

_PID = 1                                  # single engine process per trace


class TraceEvent:
    """One recorded event.  ``ph`` follows the Chrome trace-event phase
    alphabet: "X" complete span, "i" instant, "C" counter, "s"/"t"/"f" flow
    start/step/finish.  ``ts``/``dur`` are engine-clock **seconds** (exported
    as microseconds); ``track`` is a human-readable lane name interned to a
    ``tid`` at export time; ``flow`` is the request id tying lifecycle events
    into one arrow chain across slots."""

    __slots__ = ("name", "cat", "ph", "track", "ts", "dur", "args", "flow")

    def __init__(self, name: str, cat: str, ph: str, track: str, ts: float,
                 dur: float = 0.0, args: Optional[dict] = None,
                 flow: Optional[int] = None):
        self.name = name
        self.cat = cat
        self.ph = ph
        self.track = track
        self.ts = ts
        self.dur = dur
        self.args = args
        self.flow = flow


class NullTracer:
    """No-op recorder — the trace-off default.

    ``enabled`` is False so call sites guard the *argument construction*,
    not just the call::

        if tracer.enabled:
            tracer.span("decode", "dispatch", track, t0, dur, args={...})

    Every method is still safe to call (does nothing), so forgetting a guard
    costs a no-op call, never a crash.
    """

    enabled = False
    dropped_events = 0

    def set_clock(self, clock: Callable[[], float]) -> None:
        pass

    def span(self, name, cat, track, ts, dur, args=None, flow=None) -> None:
        pass

    def instant(self, name, cat, track, ts=None, args=None, flow=None) -> None:
        pass

    def counter(self, name, track, values, ts=None) -> None:
        pass

    def flow_event(self, phase, name, track, fid, ts=None) -> None:
        pass

    def events(self) -> Tuple:
        return ()


NULL_TRACER = NullTracer()


class Tracer(NullTracer):
    """Ring-buffered structured event recorder.

    ``capacity`` bounds memory: at overflow the **oldest** events are dropped
    and ``dropped_events`` counts them, so the tail of a long run — usually
    what you are debugging — always survives.  Timestamps default to the
    attached clock (the engine injects its own run clock via ``set_clock``);
    span emit sites pass explicit ``ts``/``dur`` measured around the
    dispatch.
    """

    enabled = True

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._events: deque = deque()
        self.dropped_events = 0
        self._clock: Callable[[], float] = lambda: 0.0
        self._tracks: Dict[str, int] = {}

    def set_clock(self, clock: Callable[[], float]) -> None:
        """Attach the timestamp source (the engine's run clock, seconds)."""
        self._clock = clock

    # -- recording ----------------------------------------------------------

    def _push(self, ev: TraceEvent) -> None:
        if len(self._events) >= self.capacity:
            self._events.popleft()
            self.dropped_events += 1
        self._events.append(ev)

    def span(self, name: str, cat: str, track: str, ts: float, dur: float,
             args: Optional[dict] = None, flow: Optional[int] = None) -> None:
        """A completed span (``X``): one dispatch / copy / prefill chunk."""
        self._push(TraceEvent(name, cat, "X", track, ts, dur, args, flow))

    def instant(self, name: str, cat: str, track: str,
                ts: Optional[float] = None, args: Optional[dict] = None,
                flow: Optional[int] = None) -> None:
        """A point event (``i``): lifecycle transitions, scheduler decisions."""
        ts = self._clock() if ts is None else ts
        self._push(TraceEvent(name, cat, "i", track, ts, 0.0, args, flow))

    def counter(self, name: str, track: str, values: Dict[str, float],
                ts: Optional[float] = None) -> None:
        """A counter sample (``C``): pool occupancy, free blocks, …"""
        ts = self._clock() if ts is None else ts
        self._push(TraceEvent(name, "counter", "C", track, ts, 0.0,
                              dict(values)))

    def flow_event(self, phase: str, name: str, track: str, fid: int,
                   ts: Optional[float] = None) -> None:
        """A flow-arrow anchor: ``phase`` ∈ {"s", "t", "f"} (start / step /
        finish).  One chain per request id follows it across slot moves."""
        if phase not in ("s", "t", "f"):
            raise ValueError(f"flow phase must be s/t/f, got {phase!r}")
        ts = self._clock() if ts is None else ts
        self._push(TraceEvent(name, "request", phase, track, ts, 0.0,
                              None, fid))

    # -- access / export ----------------------------------------------------

    def events(self) -> Tuple[TraceEvent, ...]:
        return tuple(self._events)

    def __len__(self) -> int:
        return len(self._events)

    def to_chrome(self) -> dict:
        """The Chrome trace-event JSON object (``{"traceEvents": [...]}``)."""
        return chrome_trace(self.events(), dropped_events=self.dropped_events)

    def export(self, path: str) -> dict:
        """Validate + write the Chrome trace JSON; returns the object."""
        obj = self.to_chrome()
        errors = validate_chrome_trace(obj)
        if errors:                         # pragma: no cover — exporter bug
            raise ValueError("invalid chrome trace: " + "; ".join(errors[:5]))
        with open(path, "w") as f:
            json.dump(obj, f, allow_nan=False)
        return obj


# ------------------------------------------------------------ step phases

PHASES = ("plan", "pack", "upload", "enqueue", "sync", "emit")
_IN_DISPATCH = ("upload", "enqueue", "sync")


def _enter(name: str):
    rng = obs.prof_range(name)
    rng.__enter__()
    return rng


class StepPhases:
    """The host phases of one engine step, :data:`PHASES` in order:

    ``plan``     step start → the dispatch function (expiry, faults, the
                 sweep, ``Scheduler.plan``, preemption, resumption and
                 admission staging, the choice of dispatch);
    ``pack``     the tile or mask built on the host (``pack_mixed``);
    ``upload``   the block tables and the step's inputs copied to the device;
    ``enqueue``  the step function's call, to its return;
    ``sync``     the ``.cpu()`` readbacks;
    ``emit``     readback → end of the step (tokens, write records,
                 completions, the step's tail).

    ``to(phase, t)`` ends the phase in progress and starts ``phase`` at
    ``t``, a reading the engine took anyway, or else at a reading of its own;
    ``kind`` opens the dispatch's ``serving/<kind>`` range, which upload,
    enqueue and sync sit inside.  With ``timed`` (the tracer records) the
    clock is read and the seconds summed; with ``ranged``
    (``xla_annotations``) each phase is a profiler range ``serving/<phase>``
    while the profiler records.  ``finish()`` closes the step and returns
    ``{"<phase>_s": seconds}`` (None untimed); the engine then pushes
    ``span``, the dispatch span its dispatch function left there, with those
    fields.
    """

    __slots__ = ("_clock", "_ranged", "_phase", "_t", "_secs", "_rng", "_kind_rng", "span")

    def __init__(self, clock: Callable[[], float], t: float, timed: bool, ranged: bool):
        self._clock = clock
        self._ranged = ranged
        self._phase = "plan"
        self._t = t
        self._secs = dict.fromkeys(PHASES, 0.0) if timed else None
        self._kind_rng = None
        self._rng = _enter("serving/plan") if ranged else None
        self.span = None

    def _close(self, keep_kind: bool) -> None:
        if self._rng is not None:
            self._rng.__exit__(None, None, None)
            self._rng = None
        if self._kind_rng is not None and not keep_kind:
            self._kind_rng.__exit__(None, None, None)
            self._kind_rng = None

    def to(self, phase: str, t: Optional[float] = None, kind: Optional[str] = None) -> None:
        self._close(phase in _IN_DISPATCH)
        if self._secs is not None:
            t = self._clock() if t is None else t
            self._secs[self._phase] += t - self._t
            self._t = t
        self._phase = phase
        if self._ranged:
            if kind is not None:
                self._kind_rng = _enter(f"serving/{kind}")
            self._rng = _enter(f"serving/{phase}")

    def finish(self) -> Optional[Dict[str, float]]:
        self._close(False)
        if self._secs is None:
            return None
        self._secs[self._phase] += self._clock() - self._t
        return {f"{p}_s": s for p, s in self._secs.items()}


# ------------------------------------------------------------ chrome export

def _track_order(track: str) -> Tuple[int, str]:
    """Slots first (numeric order), then scheduler/pool/other lanes."""
    if track.startswith("slot "):
        try:
            return (0, f"{int(track.split()[1]):06d}")
        except ValueError:
            pass
    return (1, track)


def chrome_trace(events, dropped_events: int = 0) -> dict:
    """Render recorded events as a Chrome trace-event JSON object.

    One process (`pid` 1, "serving-engine") with one thread per distinct
    track, named and sorted slots-first.  Timestamps convert seconds →
    microseconds.  ``otherData.dropped_events`` records ring-buffer drops so
    a truncated trace is detectable from the artifact alone.
    """
    tracks: Dict[str, int] = {}
    for ev in events:
        if ev.track not in tracks:
            tracks[ev.track] = 0
    for i, name in enumerate(sorted(tracks, key=_track_order)):
        tracks[name] = i

    out: List[dict] = [{"name": "process_name", "ph": "M", "pid": _PID,
                        "tid": 0, "args": {"name": "serving-engine"}}]
    for name, tid in sorted(tracks.items(), key=lambda kv: kv[1]):
        out.append({"name": "thread_name", "ph": "M", "pid": _PID, "tid": tid,
                    "args": {"name": name}})
        out.append({"name": "thread_sort_index", "ph": "M", "pid": _PID,
                    "tid": tid, "args": {"sort_index": tid}})

    for ev in events:
        rec = {"name": ev.name, "cat": ev.cat, "ph": ev.ph, "pid": _PID,
               "tid": tracks[ev.track], "ts": ev.ts * 1e6}
        if ev.ph == "X":
            rec["dur"] = max(ev.dur, 0.0) * 1e6
        if ev.ph == "i":
            rec["s"] = "t"                 # thread-scoped instant
        if ev.ph in ("s", "t", "f"):
            rec["id"] = ev.flow
            if ev.ph == "f":
                rec["bp"] = "e"            # bind to enclosing slice
        elif ev.flow is not None:
            args = dict(ev.args or {})
            args["flow_id"] = ev.flow
            rec["args"] = args
        if "args" not in rec and ev.args is not None:
            rec["args"] = ev.args
        out.append(rec)
    return {"traceEvents": out,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": dropped_events}}


_REQUIRED_KEYS = ("name", "ph", "pid", "tid")
_KNOWN_PHASES = ("X", "B", "E", "i", "I", "C", "M", "s", "t", "f")


def validate_chrome_trace(obj) -> List[str]:
    """Schema check for a Chrome trace-event JSON object (Perfetto-loadable).

    Returns a list of error strings (empty ⇒ valid).  Checks the structural
    contract Perfetto's legacy-JSON importer relies on: a ``traceEvents``
    array of objects each carrying name/ph/pid/tid, numeric non-negative
    ``ts`` (and ``dur`` for "X"), known phase letters, ids on flow events
    with every chain starting at an "s", and strict-JSON serializability
    (``NaN``/``Infinity`` tokens would make the file unloadable).
    """
    errors: List[str] = []
    if not isinstance(obj, dict) or not isinstance(obj.get("traceEvents"), list):
        return ["top level must be an object with a 'traceEvents' array"]
    # a ring-buffer overflow may have dropped a chain's "s" anchor — orphan
    # "t"/"f" events are then expected (Perfetto just skips the arrow), so
    # the ordering check only applies to complete traces
    dropped = (obj.get("otherData") or {}).get("dropped_events", 0)
    check_flow_order = not dropped
    flows_started = set()
    for i, ev in enumerate(obj["traceEvents"]):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        for k in _REQUIRED_KEYS:
            if k not in ev:
                errors.append(f"{where}: missing key {k!r}")
        ph = ev.get("ph")
        if ph not in _KNOWN_PHASES:
            errors.append(f"{where}: unknown phase {ph!r}")
            continue
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or not math.isfinite(ts) or ts < 0:
                errors.append(f"{where}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or not math.isfinite(dur) or dur < 0:
                errors.append(f"{where}: bad dur {dur!r}")
        if ph == "M":
            if not isinstance(ev.get("args"), dict):
                errors.append(f"{where}: metadata event needs args")
        if ph in ("s", "t", "f"):
            fid = ev.get("id")
            if fid is None:
                errors.append(f"{where}: flow event missing id")
            elif ph == "s":
                flows_started.add(fid)
            elif check_flow_order and fid not in flows_started:
                errors.append(f"{where}: flow {ph!r} id {fid!r} before its 's'")
        if "args" in ev and not isinstance(ev["args"], dict):
            errors.append(f"{where}: args must be an object")
    try:
        json.dumps(obj, allow_nan=False)
    except (TypeError, ValueError) as e:
        errors.append(f"not strict-JSON serializable: {e}")
    return errors


# ----------------------------------------------------------- windowed metrics

class LogHistogram:
    """Log-bucketed streaming histogram over positive values.

    ``bins_per_decade`` geometric buckets between ``lo`` and ``hi`` plus
    underflow/overflow buckets — O(1) memory per metric regardless of run
    length, with percentile error bounded by one bucket's ratio
    (``10^(1/bins_per_decade)``, ~47% at the default 3/decade; serving
    latencies span decades, so ratio resolution is the right trade).
    Percentiles interpolate at the geometric midpoint of the containing
    bucket.  ``marks()``/``delta_summary`` support windowed snapshots: the
    registry records the cumulative counts at each window open and summarizes
    the difference at close.
    """

    def __init__(self, lo: float = 1e-6, hi: float = 1e4,
                 bins_per_decade: int = 6):
        if not (0 < lo < hi):
            raise ValueError((lo, hi))
        self.lo = lo
        self.hi = hi
        self.bins_per_decade = bins_per_decade
        n = int(math.ceil(bins_per_decade * math.log10(hi / lo)))
        self._n = n
        self.counts = [0] * (n + 2)        # [under, b0..b{n-1}, over]
        self.total = 0
        self.sum = 0.0

    def _bucket(self, v: float) -> int:
        if v < self.lo:
            return 0
        if v >= self.hi:
            return self._n + 1
        return 1 + min(self._n - 1, int(self.bins_per_decade
                                        * math.log10(v / self.lo)))

    def _edges(self, b: int) -> Tuple[float, float]:
        """(low, high) value edges of bucket index ``b`` (clamped ends)."""
        if b == 0:
            return (0.0, self.lo)
        if b == self._n + 1:
            return (self.hi, self.hi)
        lo = self.lo * 10 ** ((b - 1) / self.bins_per_decade)
        return (lo, lo * 10 ** (1 / self.bins_per_decade))

    def observe(self, v: float) -> None:
        self.counts[self._bucket(v)] += 1
        self.total += 1
        self.sum += v

    def marks(self) -> Tuple[List[int], int, float]:
        return (list(self.counts), self.total, self.sum)

    def _percentile_from(self, counts: List[int], total: int,
                         q: float) -> Optional[float]:
        if total == 0:
            return None
        target = q / 100.0 * total
        acc = 0
        for b, c in enumerate(counts):
            acc += c
            if acc >= target and c:
                lo, hi = self._edges(b)
                return math.sqrt(lo * hi) if lo > 0 else 0.0
        return self._edges(len(counts) - 1)[1]   # pragma: no cover

    def percentile(self, q: float) -> Optional[float]:
        return self._percentile_from(self.counts, self.total, q)

    def summary(self, qs=(50, 90, 99)) -> dict:
        return self.delta_summary(([0] * len(self.counts), 0, 0.0), qs)

    def delta_summary(self, marks: Tuple[List[int], int, float],
                      qs=(50, 90, 99)) -> dict:
        """Summary of observations since ``marks`` (a window's worth)."""
        counts0, total0, sum0 = marks
        counts = [a - b for a, b in zip(self.counts, counts0)]
        total = self.total - total0
        out = {"count": total,
               "mean": (self.sum - sum0) / total if total else None}
        for q in qs:
            out[f"p{q}"] = self._percentile_from(counts, total, q)
        return out


class MetricsRegistry:
    """Counters, gauges and log-bucketed histograms with periodic windows.

    The engine feeds observations (``observe``) and counter values as it
    runs; every ``window_s`` seconds of engine clock ``maybe_roll`` closes a
    window — a dict of counter **deltas** and per-histogram delta summaries —
    appended to ``windows``.  Long runs therefore report p50/p99 *over time*
    (TTFT during the arrival burst vs steady state) instead of one
    end-of-run number.  Empty windows (no observations, no counter movement)
    are elided, keeping idle gaps cheap; window boundaries stay aligned to
    ``k·window_s`` so gaps are visible as missing ``t0`` values.
    """

    def __init__(self, window_s: float = 1.0, hist_lo: float = 1e-6,
                 hist_hi: float = 1e4, bins_per_decade: int = 6):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.window_s = window_s
        self._hist_kw = dict(lo=hist_lo, hi=hist_hi,
                             bins_per_decade=bins_per_decade)
        self.hists: Dict[str, LogHistogram] = {}
        self.gauges: Dict[str, float] = {}
        self.windows: List[dict] = []
        self._next: Optional[float] = None
        self._marks: Dict[str, Tuple[List[int], int, float]] = {}
        self._counters0: Dict[str, float] = {}

    # -- feeding ------------------------------------------------------------

    def observe(self, name: str, v: float) -> None:
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = LogHistogram(**self._hist_kw)
            self._marks[name] = ([0] * len(h.counts), 0, 0.0)
        h.observe(v)

    def set_gauge(self, name: str, v: float) -> None:
        self.gauges[name] = float(v)

    # -- windowing ----------------------------------------------------------

    def maybe_roll(self, now: float,
                   counters: Optional[Dict[str, float]] = None) -> None:
        """Close every window boundary passed by ``now``.  ``counters`` is
        the current cumulative counter snapshot (e.g. off ``EngineStats``);
        each window records the delta since the previous close."""
        if self._next is None:
            self._next = (math.floor(now / self.window_s) + 1) * self.window_s
            self._counters0 = dict(counters or {})
            return
        while now >= self._next:
            self._close(self._next - self.window_s, self._next, counters)
            self._next += self.window_s

    def flush(self, now: float,
              counters: Optional[Dict[str, float]] = None) -> None:
        """Close the in-progress partial window (end of run / snapshot)."""
        if self._next is None:
            return
        self.maybe_roll(now, counters)
        if now > self._next - self.window_s:
            self._close(self._next - self.window_s, now, counters)
            self._next = (math.floor(now / self.window_s) + 1) * self.window_s

    def _close(self, t0: float, t1: float,
               counters: Optional[Dict[str, float]]) -> None:
        hist_deltas = {}
        n_obs = 0
        for name, h in self.hists.items():
            d = h.delta_summary(self._marks[name])
            self._marks[name] = h.marks()
            if d["count"]:
                hist_deltas[name] = d
                n_obs += d["count"]
        counter_deltas = {}
        if counters is not None:
            for k, v in counters.items():
                dv = v - self._counters0.get(k, 0)
                if dv:
                    counter_deltas[k] = dv
            self._counters0 = dict(counters)
        if not n_obs and not counter_deltas:
            return                          # elide empty windows
        self.windows.append({"t0": t0, "t1": t1,
                             "counters": counter_deltas,
                             "histograms": hist_deltas})

    # -- reporting ----------------------------------------------------------

    def summary(self) -> dict:
        return {
            "window_s": self.window_s,
            "windows": self.windows,
            "histograms": {k: h.summary() for k, h in self.hists.items()},
            "gauges": dict(self.gauges),
        }


# -------------------------------------------------------------- validator CLI

def main(argv=None):                       # pragma: no cover — CI entry point
    import argparse
    ap = argparse.ArgumentParser(
        description="Validate a Chrome trace-event JSON file (Perfetto schema)")
    ap.add_argument("path", help="trace JSON file to validate")
    args = ap.parse_args(argv)
    with open(args.path) as f:
        obj = json.load(f)
    errors = validate_chrome_trace(obj)
    n = len(obj.get("traceEvents", [])) if isinstance(obj, dict) else 0
    if errors:
        for e in errors[:20]:
            print(f"INVALID: {e}")
        raise SystemExit(1)
    print(f"OK: {args.path} — {n} events, schema valid")


if __name__ == "__main__":                 # pragma: no cover
    main()
