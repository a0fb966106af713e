"""Share of the device's busy time in the optimizer: the device seconds of
the profiler's ``optim/adamw`` range rows (``repro_torch/optim/adamw.py``,
the in-place AdamW update) over the profiled busy time of a training
window."""


def read(run):
    rec = run["record"]
    prof = rec.get("profile")
    if prof is None or rec["kind"] != "train" or prof["busy_s"] <= 0:
        return None
    s = sum(dev for name, _, dev, _ in prof["op_rows"] if name == "optim/adamw")
    return 100.0 * s / prof["busy_s"] if s else None
