"""Median of submit → first token over every request whose first token
falls in the window; a request that failed in the window counts as
infinite (reported as 1e9 s should the median be one)."""
import math
import statistics

FAILED = ("failed", "timeout", "cancelled")


def read(run):
    rec = run["record"]
    if rec["kind"] != "serve":
        return None
    t0, t1 = rec["t0"], rec["t1"]
    vals = [r["times"][0] - r["t_submit"] for r in rec["requests"]
            if r["times"] and t0 < r["times"][0] <= t1]
    vals += [math.inf for r in rec["requests"]
             if r["state"] in FAILED and t0 < r["t_submit"] <= t1]
    if not vals:
        return None
    med = statistics.median(vals)
    return med if math.isfinite(med) else 1e9
