"""Trained tokens of the steps completed in the window over the window's
seconds (each step ends in its loss's readback)."""


def read(run):
    rec = run["record"]
    if rec["kind"] != "train" or not rec["steps"]:
        return None
    return len(rec["steps"]) * rec["tokens_per_step"] / (rec["t1"] - rec["t0"])
