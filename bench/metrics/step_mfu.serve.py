"""Model FLOPs of the prompt and output tokens processed in the unprofiled
part of a traced serving window (``work/model_step.py``: the
projections, causal attention over each row's real context, the head once
an emitted token; no pad rows) over its seconds × the bfloat16 peak."""
from harness.records import decode_ctx_between, measured_span, prefill_between, tokens_between
from work.model_step import PEAK_BF16_FLOPS, serve_flops


def read(run):
    rec = run["record"]
    if rec["kind"] != "serve":
        return None
    a, b = measured_span(rec)
    flops = serve_flops(run["dims"], prefill_between(rec, a, b), decode_ctx_between(rec, a, b),
                        tokens_between(rec, a, b))
    return 100.0 * flops / ((b - a) * PEAK_BF16_FLOPS) if flops else None
