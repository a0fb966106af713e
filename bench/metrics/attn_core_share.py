"""Share of the device's busy time in the serving attention cores: the
device seconds of the profiler's ``attn/core`` range rows (the cache writes
and the attention over the cache, ``repro_torch/nn/attention.py``) over the
profiled busy time of a serving window."""


def read(run):
    rec = run["record"]
    prof = rec.get("profile")
    if prof is None or rec["kind"] != "serve" or prof["busy_s"] <= 0:
        return None
    s = sum(dev for name, _, dev, _ in prof["op_rows"] if name == "attn/core")
    return 100.0 * s / prof["busy_s"] if s else None
