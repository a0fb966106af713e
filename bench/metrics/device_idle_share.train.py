"""Share of the profiled stretch of a training window in which no device
operation ran."""


def read(run):
    prof = run["record"].get("profile")
    if prof is None or run["record"]["kind"] != "train" or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
