"""The device trace of a traced run: ``torch.profiler`` over a sub-window,
reduced to the numbers the per-layer readers take.

Busy time is the union of the device-side intervals (kernels, copies,
sets) in the profiler's trace; the window is the host clock's length of
the profiled stretch, which starts and ends on a synchronised device.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

__all__ = ["DeviceProfile", "merge_intervals"]


def merge_intervals(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _device_us(e) -> float:
    v = getattr(e, "device_time_total", None)
    return float(v if v is not None else getattr(e, "cuda_time_total", 0.0))


class DeviceProfile:
    """``start()`` and ``stop()`` around whole calls into the program; the
    trace is read at ``stop()``, after the profiled stretch's end time."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.t0 = self.t1 = 0.0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self) -> None:
        """Pay the profiler's one-time start-up (set-up, not the window)."""
        self.start()
        self.stop()
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self.prof = profile(activities=acts, record_shapes=True)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self._sync()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def reduce(self) -> Dict:
        """window_s, busy_s, device seconds by kernel name, operator rows
        (name, first input's shape, device seconds, calls) and the breakdown
        of the result line."""
        from torch.autograd import DeviceType

        events = self.prof.events()
        dev, host = [], []
        for e in events:
            if e.device_type == DeviceType.CUDA:
                if not getattr(e, "is_user_annotation", False):
                    dev.append(e)
            elif e.device_type == DeviceType.CPU:
                host.append(e)
        kernel_s: Dict[str, float] = defaultdict(float)
        for e in dev:
            kernel_s[e.name] += (e.time_range.end - e.time_range.start) / 1e6
        merged = merge_intervals([(e.time_range.start, e.time_range.end) for e in dev])
        busy_s = sum(b - a for a, b in merged) / 1e6
        rows = []
        for e in self.prof.key_averages(group_by_input_shape=True):
            if e.device_type != DeviceType.CPU or _device_us(e) <= 0:
                continue
            shape0 = list(e.input_shapes[0]) if e.input_shapes and e.input_shapes[0] else []
            rows.append((e.key, shape0, _device_us(e) / 1e6, int(e.count)))
        top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
        return {"window_s": self.t1 - self.t0, "busy_s": busy_s, "kernel_s": dict(kernel_s),
                "op_rows": rows,
                "breakdown": {"device_ops": [[n, s] for n, s in top],
                              "idle_gaps": self._idle_gaps(merged, host)}}

    @staticmethod
    def _idle_gaps(merged, host, n_gaps: int = 400) -> List:
        """Idle time between device intervals by what the host was doing:
        the innermost host operator or range covering each of the longest
        gaps' midpoints, summed by name, the ten largest."""
        gaps = sorted(((b2 - a1, (a1 + b2) / 2) for (_, a1), (b2, _) in
                       zip(merged, merged[1:])), reverse=True)[:n_gaps]
        host = sorted(host, key=lambda e: e.time_range.start)
        starts = [e.time_range.start for e in host]
        by_name: Dict[str, float] = defaultdict(float)
        for length, mid in gaps:
            label = "host outside any operator"
            i = bisect.bisect_right(starts, mid) - 1
            seen = 0
            while i >= 0 and seen < 4000:
                e = host[i]
                if e.time_range.end >= mid:
                    label = e.name
                    break
                i -= 1
                seen += 1
            by_name[label] += length / 1e6
        return [[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
