"""Model FLOPs of the training steps completed in the unprofiled part of a
traced window (``work/model_step.py train_flops``: 6 × projection and
head parameters a token plus attention; remat not counted) over its
seconds × the bfloat16 peak."""
from harness.records import measured_span
from work.model_step import PEAK_BF16_FLOPS, train_flops


def read(run):
    rec = run["record"]
    if rec["kind"] != "train":
        return None
    a, b = measured_span(rec)
    n = sum(1 for t, _, _ in rec["steps"] if a < t <= b)
    if not n:
        return None
    t = run["traffic"]
    return 100.0 * n * train_flops(run["dims"], int(t["batch"]), int(t["seq"])) / (
        (b - a) * PEAK_BF16_FLOPS)
