"""Reading a run's record: the helpers the metric readers share."""
from __future__ import annotations

from typing import Dict, List, Tuple

__all__ = ["measured_span", "tokens_between", "token_bins", "decode_ctx_between",
           "prefill_between"]


def measured_span(record: Dict) -> Tuple[float, float]:
    """The part of the window the profiler left alone: all of it in an
    untraced run, the stretch before the profiled end of a traced one (all
    of it again if the profile took the whole window)."""
    t0, t1 = record["t0"], record["t1"]
    prof = record.get("profile")
    if prof is not None and prof["t0"] > t0 + 1e-3:
        return t0, min(prof["t0"], t1)
    return t0, t1


def tokens_between(record: Dict, a: float, b: float) -> int:
    return sum(1 for r in record["requests"] for t in r["times"] if a < t <= b)


def token_bins(record: Dict, start: float, end: float, width: float) -> List[int]:
    """Tokens delivered in each bin of ``width`` seconds from ``start`` to
    ``end``: the rate through set-up and window, to see where it settles."""
    n = max(1, int(round((end - start) / width)))
    out = [0] * n
    for r in record["requests"]:
        for t in r["times"]:
            if start < t <= end:
                out[min(n - 1, int((t - start) / width))] += 1
    return out


def decode_ctx_between(record: Dict, a: float, b: float) -> List[int]:
    """Context length (keys attended, its own included) of every decode row
    whose token was emitted in (a, b]: token k ≥ 2 of a request decodes
    over its prompt and the k - 1 tokens before it."""
    out = []
    for r in record["requests"]:
        for k, t in enumerate(r["times"], start=1):
            if k >= 2 and a < t <= b:
                out.append(r["prompt_len"] + k - 1)
    return out


def prefill_between(record: Dict, a: float, b: float) -> List[Tuple[int, int]]:
    """(start, rows) of every prefill chunk run in (a, b]."""
    return [(s, n) for t, s, n in record["prefill_rows"] if a < t <= b]
