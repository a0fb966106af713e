"""Model FLOPs of a decoder step, from the configuration file's widths.

What the model needs, not what an implementation issues: no pad rows, no
recomputation, attention over each row's real causal context, and only
the routed experts of an MoE layer.  A multiply-add is two FLOPs.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

__all__ = ["linear_flops_per_token", "attn_flops", "head_flops", "serve_flops",
           "train_flops", "PEAK_BF16_FLOPS"]

# NVIDIA H100 SXM, dense bfloat16 tensor-core peak (data sheet, 700 W)
PEAK_BF16_FLOPS = 989e12


def linear_flops_per_token(m: Dict) -> float:
    """Every layer's projections for one token (router and routed experts
    for MoE), the head excluded."""
    d, H, Hkv, D, F = m["d"], m["H"], m["Hkv"], m["D"], m["F"]
    attn = d * H * D + 2 * d * Hkv * D + H * D * d
    mlp = d * m["E"] + m["top_k"] * 3 * d * F if m["moe"] else 3 * d * F
    return 2.0 * m["L"] * (attn + mlp)


def attn_flops(m: Dict, start: int, n: int) -> float:
    """Causal attention of ``n`` query rows at positions start..start+n-1,
    each over its keys 0..p: QKᵀ and PV, every layer."""
    keys = (start + n) * (start + n + 1) // 2 - start * (start + 1) // 2
    return 4.0 * m["L"] * m["H"] * m["D"] * keys


def head_flops(m: Dict) -> float:
    return 2.0 * m["d"] * m["V"]


def serve_flops(m: Dict, prefill: Iterable[Tuple[int, int]], decode_ctx: Iterable[int],
                n_heads_run: int) -> float:
    """Prefill chunks (start, rows), decode rows by their context length
    (keys attended, the new one included), and the head once for each
    emitted token."""
    total = 0.0
    lin = linear_flops_per_token(m)
    for start, n in prefill:
        total += lin * n + attn_flops(m, start, n)
    for ctx in decode_ctx:
        total += lin + attn_flops(m, ctx - 1, 1)
    return total + head_flops(m) * n_heads_run


def train_flops(m: Dict, batch: int, seq: int) -> float:
    """One training step: 6 × (projection and head parameters) a token,
    plus three times the forward's causal attention."""
    tokens = batch * seq
    dense = 6.0 * (linear_flops_per_token(m) / 2.0 + m["d"] * m["V"]) * tokens
    return dense + 3.0 * batch * attn_flops(m, 0, seq)
