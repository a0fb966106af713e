"""Mean host time of an engine step outside its dispatch: the plan, pack
and emit seconds (``repro_torch.serving.trace.StepPhases``) of the
engine's ``mixed`` and ``decode`` dispatch spans in the unprofiled part of
a traced window."""
from harness.records import measured_span

FIELDS = ("plan_s", "pack_s", "emit_s")


def read(run):
    rec = run["record"]
    a, b = measured_span(rec)
    vals = [sum(s["args"][f] for f in FIELDS) for s in rec.get("spans", ())
            if s["name"] in ("mixed", "decode") and a <= s["ts"] < b
            and all(f in s["args"] for f in FIELDS)]
    return 1e3 * sum(vals) / len(vals) if vals else None
