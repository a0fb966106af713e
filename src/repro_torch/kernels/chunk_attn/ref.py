"""Plain PyTorch version of the chunk-attention kernel.

The chunked-prefill numerics of ``nn/attention.py _gather_attend`` and of
the JAX package's jnp core (inline in ``src/repro/nn/attention.py
_paged_gqa_core``): gather every page of each slot's table into a dense
``[B, P·bs, Hkv, D]`` copy, dequantise an int8 pool into q's dtype, bias
keys at or past the slot's length and outside each row's causal window by
``NEG_INF``, then a float32 softmax attention, cast to q's dtype.  On top
of that it gives the kernel's zeros: pad rows (the first ``S − q_lens``
rows of a slot) and real rows that see no key read exactly 0.  No program
path runs it: the tests hold it against ``_gather_attend`` and the JAX
package's core on the CPU, and the CUDA kernel against it on the card, as
``chip_smoke.py`` does.
"""
from __future__ import annotations

import math

import torch

__all__ = ["chunk_attn_ref"]

NEG_INF = -1e30


def chunk_attn_ref(q, k_pool, v_pool, tables, lengths, q_lens=None, *, window: int = 0,
                   kv_scale=None):
    """q [B, S, H, D] against pools [N, bs, Hkv, D] via tables [B, P] →
    [B, S, H, D] in q's dtype.  ``lengths [B]`` counts each slot's visible
    keys including this tile's rows; ``q_lens [B]`` its real rows,
    right-aligned (None: all S)."""
    B, S, H, D = q.shape
    P = tables.shape[1]
    _, bs, Hkv, _ = k_pool.shape
    dev = q.device
    tab = tables.long()
    k = k_pool[tab].reshape(B, P * bs, Hkv, D)
    v = v_pool[tab].reshape(B, P * bs, Hkv, D)
    if k_pool.dtype == torch.int8:
        k = (k.float() * (1.0 / kv_scale)).to(q.dtype)
        v = (v.float() * (1.0 / kv_scale)).to(q.dtype)
    rows = torch.arange(P * bs, dtype=torch.int32, device=dev)[None, :]
    k_pos = torch.where(rows < lengths[:, None], rows, 2**30).to(torch.int32)   # [B, P·bs]
    idx = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    q_pos = (lengths.to(torch.int32)[:, None] - S + idx).to(torch.int32)       # [B, S]
    ok = k_pos[:, None, :] <= q_pos[:, :, None]
    if window:
        ok &= k_pos[:, None, :] > q_pos[:, :, None] - window
    bias = torch.where(ok, 0.0, NEG_INF)[:, None]                               # [B,1,S,P·bs]
    G = H // Hkv
    qg = q.reshape(B, S, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * (1.0 / math.sqrt(D))
    s = s + bias[:, :, None, :, :]
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    o = o.reshape(B, S, H, D).to(q.dtype)
    keep = ok.any(dim=-1)                                                        # [B, S]
    if q_lens is not None:
        keep &= idx >= (S - q_lens.to(torch.int32))[:, None]
    return torch.where(keep[:, :, None, None], o, torch.zeros((), dtype=o.dtype, device=dev))
