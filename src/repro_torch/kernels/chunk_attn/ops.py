"""Entry point for chunk attention: ``chunk_attn(q, k_pool, v_pool, tables,
lengths, q_lens)``, the core of a chunked prefill or a mixed tile over the
paged KV pool, once a layer, through the hand-written CUDA kernel
(``csrc/chunk_attn.cu``).

One launch a call, its work items and CTAs from the shapes alone: it never
reads ``lengths``, ``q_lens`` or ``tables`` on the host, which would make
the host wait for the device every layer.  It launches or raises, never
falls back.  :func:`covers` says which calls the kernel takes; the caller
(``nn/attention.py _chunk_core``) runs the plain gather + ``sdpa`` core on
every other.  ``chunk_attn.launches`` counts the launches.  ``ref.py``
holds the plain version that tests and ``chip_smoke.py`` compare with.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels.paged_attn.ops import sm_count

__all__ = ["chunk_attn", "covers", "takes", "launch_plan", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "chunk_attn.cu"

_KV_CODE = {torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (64, 128)
_MAX_BLOCK = 64
_LOG2E = 1.4426950408889634


def takes(q: torch.Tensor, k_pool: torch.Tensor) -> bool:
    """Whether the kernel takes these shapes and dtypes, wherever the
    tensors live: q [B, S, H, D] bf16 over a bf16 or int8 pool [N, bs, Hkv,
    D] with D 64 or 128, a block size that divides 64 (the pages of a key
    block) and whole groups of query heads."""
    if q.dim() != 4 or k_pool.dim() != 4:
        return False
    D, (bs, Hkv, D_p) = q.shape[3], k_pool.shape[1:]
    return (q.dtype == torch.bfloat16 and k_pool.dtype in _KV_CODE and D == D_p
            and D in _HEAD_DIMS and 1 <= bs <= _MAX_BLOCK and _MAX_BLOCK % bs == 0
            and Hkv >= 1 and q.shape[2] % Hkv == 0)


def covers(q: torch.Tensor, k_pool: torch.Tensor) -> bool:
    """Whether a call on these tensors belongs to the kernel: both on the
    card and :func:`takes`.  A float32 q or pool, the CPU, another head dim
    or block size keep the plain gather + ``sdpa`` core."""
    return q.is_cuda and k_pool.is_cuda and takes(q, k_pool)


def launch_plan(B: int, S: int, Hkv: int, G: int, D: int, kv_elt: int, n_sm: int) -> dict:
    """The kernel's work items and launch: an item is 64 packed query rows
    (query row ``i``, head ``g`` of a KV head at row ``i·G + g``; 16 rows a
    warp of one warpgroup) of one (slot, KV head), against blocks of 64
    keys; ``ctas`` persistent CTAs, two a streaming multiprocessor, walk the
    ``items``.  Dynamic shared memory: the query rows in bf16, two stages of
    K and V blocks in the pool's type (filled by TMA), for an int8 pool a
    block's bf16 tiles, the stages' two mbarriers, and 1 KB to align the
    tiles to the swizzle's 1,024 bytes."""
    rows, keys, stages = 64, 64, 2
    items = -(-S * G // rows) * B * Hkv
    smem = (rows * D * 2 + 2 * stages * keys * D * kv_elt
            + (2 * keys * D * 2 if kv_elt == 1 else 0) + 16 + 1024)
    return dict(rows=rows, keys=keys, items=items, ctas=max(1, min(items, 2 * n_sm)), smem=smem)


@functools.cache
def _library() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load(SOURCE)
    fn = lib.chunk_attn_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_float] * 2
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def chunk_attn(q, k_pool, v_pool, tables, lengths, q_lens=None, *, window: int = 0,
               kv_scale=None) -> torch.Tensor:
    """q [B, S, H, D] against pools [N, bs, Hkv, D] via tables [B, P] →
    [B, S, H, D] in q's dtype, on the card.

    ``lengths [B]`` counts each slot's visible keys *including this tile's
    rows* (row ``i`` sits at ``lengths − S + i`` and attends causally, as
    ``paged_attention``'s ``lengths``); ``q_lens [B]`` (None: all S) its real
    rows, right-aligned.  Pad rows, and rows that see no key, give exactly 0.
    ``kv_scale`` set ⇒ the pools hold fixed-point int8 (values/kv_scale).
    Raises on anything :func:`covers` refuses.
    """
    q = q.contiguous()
    tables, lengths = tables.to(torch.int32).contiguous(), lengths.to(torch.int32).contiguous()
    if q_lens is not None:
        q_lens = q_lens.to(torch.int32).contiguous()
    dev = q.device
    named = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool), ("tables", tables),
             ("lengths", lengths)] + ([("q_lens", q_lens)] if q_lens is not None else [])
    for name, t in named:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not takes(q, k_pool) or v_pool.dtype != k_pool.dtype or v_pool.shape != k_pool.shape:
        raise ValueError(f"q {q.dtype} {tuple(q.shape)} over pools {k_pool.dtype} "
                         f"{tuple(k_pool.shape)} / {v_pool.dtype} {tuple(v_pool.shape)}: "
                         f"not a case the kernel takes (see covers)")
    if (k_pool.dtype == torch.int8) != (kv_scale is not None):
        raise ValueError("kv_scale goes with an int8 pool, and only with one")
    B, S, H, D = q.shape
    N, bs, Hkv, _ = k_pool.shape
    if tables.dim() != 2 or tables.shape[0] != B or tuple(lengths.shape) != (B,) \
            or (q_lens is not None and tuple(q_lens.shape) != (B,)):
        raise ValueError(f"tables {tuple(tables.shape)} / lengths {tuple(lengths.shape)} "
                         f"do not match batch {B}")
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("q and the pools must start on a 16-byte boundary")
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    plan = launch_plan(B, S, Hkv, H // Hkv, D, k_pool.element_size(), sm_count(dev.index or 0))
    if plan["items"] >= 2**31:
        raise ValueError(f"{plan['items']} work items overflow the kernel's int")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().chunk_attn_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
        lengths.data_ptr(), q_lens.data_ptr() if q_lens is not None else None,
        out.data_ptr(), B, S, H, Hkv, D, bs, tables.shape[1], N, int(window),
        _LOG2E / math.sqrt(D), 1.0 / kv_scale if kv_scale is not None else 1.0,
        _KV_CODE[k_pool.dtype], plan["smem"], plan["ctas"], stream)
    if err:
        raise RuntimeError(f"chunk_attn kernel launch failed: cudaError {err}")
    chunk_attn.launches += 1
    return out


chunk_attn.launches = 0
