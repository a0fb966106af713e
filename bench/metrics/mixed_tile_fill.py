"""Share of the mixed tile's rows that carry a real query row: Σ rows over
Σ slots × q_tile of the engine's ``mixed`` dispatch spans in the
unprofiled part of a traced window."""
from harness.records import measured_span


def _spans(run):
    rec = run["record"]
    a, b = measured_span(rec)
    return [s for s in rec.get("spans", ()) if s["name"] == "mixed" and a <= s["ts"] < b]


def read(run):
    spans = _spans(run)
    if not spans:
        return None
    slots = int(run["traffic"]["engine"]["slots"])
    return 100.0 * sum(s["args"]["rows"] for s in spans) / sum(
        slots * s["args"]["q_tile"] for s in spans)
