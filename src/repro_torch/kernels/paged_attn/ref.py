"""Plain PyTorch version of the paged-attention kernel.

A transcription of the JAX package's ``kernels/paged_attn/ref.py``: gather
every table page from the pool into a dense ``[B, P·bs]`` view and run a
masked softmax in float32.  The CPU path of :func:`paged_attention` runs it,
and ``chip_smoke.py`` holds the CUDA kernel against it on the card.

:func:`paged_attn_split_ref` mirrors the kernel's own algorithm (partials
over page ranges, then the combine formula) for the tests; no path of the
port runs it.
"""
from __future__ import annotations

import math

import torch

__all__ = ["paged_attn_ref", "paged_attn_split_ref"]

NEG_INF = -1e30


def _scores(q, k_pool, v_pool, tables, lengths, window, kv_scale, q_len):
    """Gathered V [B, P·bs, Hkv, D] in float32, scores [B, Hkv, Q·G, P·bs]
    (NEG_INF where masked) and the visibility mask [B, 1, Q·G, P·bs]."""
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
    return v, torch.where(okb, s, NEG_INF), okb


def paged_attn_split_ref(q, k_pool, v_pool, tables, lengths, *, pages_per_split: int,
                         window: int = 0, kv_scale=None, q_len: int = 1):
    """The CUDA kernel's algorithm in plain PyTorch: split the table's pages
    into ranges of ``pages_per_split``; each range gives a partial
    ``(m_i, l_i, acc_i)`` over its visible keys (``(NEG_INF, 0, 0)`` when it
    has none); then ``out = Σ exp(m_i − M)·acc_i / max(Σ exp(m_i − M)·l_i,
    1e-30)`` with ``M = max m_i``.  Same arguments and result as
    :func:`paged_attn_ref`."""
    B, Hkv, QG, D = q.shape
    bs = k_pool.shape[1]
    P = tables.shape[1]
    n_splits = max(1, -(-P // pages_per_split))
    v, s, okb = _scores(q, k_pool, v_pool, tables, lengths, window, kv_scale, q_len)
    pad = n_splits * pages_per_split * bs - P * bs          # masked keys past P
    s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
    okb = torch.nn.functional.pad(okb, (0, pad), value=False)
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    keys = pages_per_split * bs
    s = s.reshape(B, Hkv, QG, n_splits, keys)
    okb = okb.reshape(B, 1, QG, n_splits, keys)
    v = v.reshape(B, n_splits, keys, Hkv, D)
    m = s.amax(dim=-1)                                                   # [B,Hkv,QG,S]
    p = torch.where(okb, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgsk,bskhd->bhgsd", p, v)                       # [B,Hkv,QG,S,D]
    M = m.amax(dim=-1, keepdim=True)
    e = torch.exp(m - M)                                     # an empty partial adds e·0
    L = (e * l).sum(dim=-1)
    o = (e[..., None] * acc).sum(dim=-2) / torch.clamp(L, min=1e-30)[..., None]
    return o.to(q.dtype)


def paged_attn_ref(q, k_pool, v_pool, tables, lengths, *, window: int = 0,
                   kv_scale=None, q_len: int = 1):
    """q [B,Hkv,Q·G,D], pools [N,bs,Hkv,D], tables [B,P], lengths [B]
    → [B,Hkv,Q·G,D] in q's dtype.

    Row ``q·G + g`` of the query tile is query token ``q`` at absolute
    position ``lengths - q_len + q`` (causally masked per row); ``q_len=1``
    is plain decode.  A row with no visible key gives exactly 0.
    """
    v, s, okb = _scores(q, k_pool, v_pool, tables, lengths, window, kv_scale, q_len)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(okb, torch.exp(s - m), 0.0)                          # exact 0 when empty
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v) / torch.clamp(l, min=1e-30)
    return o.to(q.dtype)
