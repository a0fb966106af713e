"""Mean host time the engine's step function takes to launch its work,
from its call to its return, before any readback: the ``enqueue_s`` of the
engine's ``mixed`` and ``decode`` dispatch spans in the unprofiled part of
a traced window."""
from harness.records import measured_span


def read(run):
    rec = run["record"]
    a, b = measured_span(rec)
    vals = [s["args"]["enqueue_s"] for s in rec.get("spans", ())
            if s["name"] in ("mixed", "decode") and a <= s["ts"] < b and "enqueue_s" in s["args"]]
    return 1e3 * sum(vals) / len(vals) if vals else None
