"""Mean wall of the engine's ``mixed`` dispatch spans (each ends in the
step's token readback) in the unprofiled part of a traced window."""
from harness.records import measured_span


def read(run):
    rec = run["record"]
    a, b = measured_span(rec)
    walls = [s["dur"] for s in rec.get("spans", ()) if s["name"] == "mixed" and a <= s["ts"] < b]
    return 1e3 * sum(walls) / len(walls) if walls else None
