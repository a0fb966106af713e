"""The paged attention kernel's share of its bytes roofline over the
profiled stretch: the bytes the decode rows emitted there need
(``work/paged_attn.py``) over 3.35 TB/s, divided by the device time of
the kernel rows whose name contains ``paged_attn``."""
from harness.records import decode_ctx_between
from work.paged_attn import PEAK_HBM_BYTES_S, decode_bytes


def read(run):
    rec = run["record"]
    prof = rec.get("profile")
    if prof is None or rec["kind"] != "serve":
        return None
    t = sum(s for name, s in prof["kernel_s"].items() if "paged_attn" in name)
    ctxs = decode_ctx_between(rec, prof["t0"], prof["t1"])
    if t <= 0 or not ctxs:
        return None
    return 100.0 * decode_bytes(run["dims"], ctxs, rec["block_size"]) / PEAK_HBM_BYTES_S / t
