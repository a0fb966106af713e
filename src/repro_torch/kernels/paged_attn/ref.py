"""Plain PyTorch version of the paged-attention kernel.

A transcription of the JAX package's ``kernels/paged_attn/ref.py``: gather
every table page from the pool into a dense ``[B, P·bs]`` view and run a
masked softmax in float32.  The CPU path of :func:`paged_attention` runs it,
and ``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import math

import torch

__all__ = ["paged_attn_ref"]

NEG_INF = -1e30


def paged_attn_ref(q, k_pool, v_pool, tables, lengths, *, window: int = 0,
                   kv_scale=None, q_len: int = 1):
    """q [B,Hkv,Q·G,D], pools [N,bs,Hkv,D], tables [B,P], lengths [B]
    → [B,Hkv,Q·G,D] in q's dtype.

    Row ``q·G + g`` of the query tile is query token ``q`` at absolute
    position ``lengths - q_len + q`` (causally masked per row); ``q_len=1``
    is plain decode.  A row with no visible key gives exactly 0.
    """
    B, Hkv, QG, D = q.shape
    bs = k_pool.shape[1]
    P = tables.shape[1]
    G = QG // q_len
    dev = q.device
    tab = tables.long()
    k = k_pool[tab].reshape(B, P * bs, Hkv, D).float()
    v = v_pool[tab].reshape(B, P * bs, Hkv, D).float()
    if kv_scale is not None:
        k = k * (1.0 / kv_scale)
        v = v * (1.0 / kv_scale)
    s = torch.einsum("bhgd,bkhd->bhgk", q.float(), k) / math.sqrt(D)
    pos = torch.arange(P * bs, dtype=torch.int32, device=dev)[None, :]   # [1, P·bs]
    q_pos = (lengths.int()[:, None] - q_len
             + torch.arange(QG, dtype=torch.int32, device=dev)[None, :] // G)  # [B, Q·G]
    ok = pos[:, None, :] <= q_pos[..., None]                             # [B, Q·G, P·bs]
    if window:
        ok = ok & (pos[:, None, :] > q_pos[..., None] - window)
    okb = ok[:, None, :, :]                                              # [B,1,Q·G,P·bs]
    s = torch.where(okb, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(okb, torch.exp(s - m), 0.0)                          # exact 0 when empty
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v) / torch.clamp(l, min=1e-30)
    return o.to(q.dtype)
