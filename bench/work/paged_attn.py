"""Bytes a decode row needs from the paged attention kernel, from the
configuration file's widths: its live K and V read once (every key of
its context, every layer, bfloat16), its query read and its output
written once, and its block-table entries.
"""
from __future__ import annotations

from typing import Dict, Iterable

__all__ = ["decode_row_bytes", "decode_bytes", "PEAK_HBM_BYTES_S"]

# NVIDIA H100 SXM, HBM3 bandwidth (data sheet)
PEAK_HBM_BYTES_S = 3.35e12


def decode_row_bytes(m: Dict, ctx: int, block_size: int, elem: int = 2) -> float:
    kv = 2 * ctx * m["Hkv"] * m["D"] * elem
    q_out = 2 * m["H"] * m["D"] * elem
    table = 4 * -(-ctx // block_size)
    return float(m["L"] * (kv + q_out + table))


def decode_bytes(m: Dict, ctxs: Iterable[int], block_size: int) -> float:
    return sum(decode_row_bytes(m, c, block_size) for c in ctxs)
