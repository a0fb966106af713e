"""Share of the device's busy time spent in the experts' products: the
profiler's operator rows of ``aten::bmm`` over E batches (E the
configuration's expert count), over the profiled busy time."""


def read(run):
    prof = run["record"].get("profile")
    E = run["dims"].get("E")
    if prof is None or not E or prof["busy_s"] <= 0:
        return None
    s = sum(dev for name, shape, dev, _ in prof["op_rows"]
            if name == "aten::bmm" and shape and shape[0] == E)
    return 100.0 * s / prof["busy_s"] if s else None
