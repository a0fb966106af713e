"""95th percentile of every gap between consecutive tokens of every
request, the gaps that end inside the window."""
import numpy as np


def read(run):
    rec = run["record"]
    if rec["kind"] != "serve":
        return None
    t0, t1 = rec["t0"], rec["t1"]
    gaps = [b - a for r in rec["requests"] for a, b in zip(r["times"], r["times"][1:])
            if t0 < b <= t1]
    return float(np.percentile(gaps, 95)) if gaps else None
