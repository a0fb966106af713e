"""Generated tokens delivered inside the window over the window's seconds
(host clock; every dispatch ends in the token readback)."""
from harness.records import tokens_between


def read(run):
    rec = run["record"]
    if rec["kind"] != "serve":
        return None
    return tokens_between(rec, rec["t0"], rec["t1"]) / (rec["t1"] - rec["t0"])
