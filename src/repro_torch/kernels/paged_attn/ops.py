"""Entry point for paged attention: ``paged_attention(q, k_pool, v_pool,
tables, lengths)``, the op the serving path calls once per layer.

It packs GQA head groups (and a small leading query axis ``[B, Q, H, D]``,
the multi-token tile) into the kernel's ``[B, Hkv, Q·G, D]`` query tile,
then runs

* the hand-written CUDA kernels (``csrc/paged_attn.cu``) for CUDA tensors:
  the page axis split across CTAs by :func:`split_plan` (from the shapes
  alone), then a combine pass; they launch or raise, never fall back; or
* the plain PyTorch version (``ref.py``) for CPU tensors.

``paged_attention.launches`` counts calls that launched the kernels, one a
call whether or not it was split (plain runs do not count).
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels.paged_attn.ref import paged_attn_ref

__all__ = ["paged_attention", "paged_attn_cuda", "split_plan", "launch_plan", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attn.cu"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_Q_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (64, 128)
_MAX_BLOCK = 64
_MAX_SMEM = 232_448        # bytes of shared memory one H100 block may use
_WARPS = 4                 # warps of a CTA of the split kernel
_LANE_VALUES = 16          # values of D a lane owns
_MAX_SPLITS = 1024         # partials the combine kernel stages in shared memory
_STAGE_BYTES = 32 * 1024   # K and V of one ring stage (of two), while a page fits


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (read once)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(B: int, Hkv: int, P: int, bs: int, n_sm: int) -> tuple[int, int]:
    """``(pages_per_split, n_splits)`` for a ``[B, P]`` table: split the page
    axis so that ``B·Hkv·n_splits`` CTAs give about two a streaming
    multiprocessor, a split holding at least 32 keys and a power of two of
    pages.  A function of the shapes alone: it never reads ``lengths`` or
    ``tables``, which would make the host wait for the device every layer."""
    if P <= 0:
        return 1, 1
    want = max(1, -(-2 * n_sm // max(1, B * Hkv)))          # splits a slot
    pages = max(1, -(-P // want))
    pages = 1 << (pages.bit_length() - 1)                    # round down to 2^k
    pages = min(P, max(pages, -(-32 // bs)))
    return pages, -(-P // pages)


def launch_plan(QG: int, D: int, bs: int, kv_elt: int, pages_per_split: int) -> dict:
    """Rows a CTA holds (RT), pages a ring stage holds and dynamic shared
    memory of the split kernel.  A lane owns 16 values of D for each of its
    RT ≤ 4 query rows (query tile and accumulator in registers); a tile of
    more rows is cut into chunks of 4 or 3 rows, whichever pads less.  The
    ring has two stages of up to 32 KB of K and V (one page when a page is
    larger), no more pages than a split holds."""
    rt = QG if QG <= 4 else min((4, 3), key=lambda r: (-(-QG // r) * r, -r))
    groups = _WARPS * 32 // (D // _LANE_VALUES)              # lane groups a CTA
    page = bs * D * kv_elt                                   # K (or V) of one page
    pages = max(1, min(pages_per_split, _STAGE_BYTES // (2 * page)))
    merge = 4 * groups * rt * (D + 2)
    return dict(rt=rt, pages_per_stage=pages, smem=max(2 * 2 * pages * page, merge),
                row_chunks=-(-QG // rt))


@functools.cache
def _library() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load(SOURCE)
    fn = lib.paged_attn_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def paged_attn_cuda(q, k_pool, v_pool, tables, lengths, *, window: int = 0,
                    kv_scale=None, q_len: int = 1) -> torch.Tensor:
    """Launch the CUDA kernels on a packed tile: q [B,Hkv,Q·G,D] → same shape
    and dtype.  Checks what the kernel takes and raises on anything else.
    One call is one split kernel, plus a combine kernel when the plan splits
    the page axis."""
    dev = q.device
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("lengths", lengths)):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, Hkv, QG, D = q.shape
    N, bs, Hkv_p, D_p = k_pool.shape
    if q.dtype not in _Q_DTYPES:
        raise ValueError(f"q dtype {q.dtype} not in {_Q_DTYPES}")
    if k_pool.dtype not in _DTYPE_CODE or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"pool dtypes {k_pool.dtype}/{v_pool.dtype} not supported")
    if v_pool.shape != k_pool.shape or (Hkv_p, D_p) != (Hkv, D):
        raise ValueError(f"pool shapes {tuple(k_pool.shape)}/{tuple(v_pool.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {_HEAD_DIMS}")
    if not 1 <= bs <= _MAX_BLOCK:
        raise ValueError(f"block size {bs} not in [1, {_MAX_BLOCK}]")
    if q_len < 1 or QG % q_len:
        raise ValueError(f"query tile {QG} not a multiple of q_len {q_len}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("tables and lengths must be int32")
    if tables.dim() != 2 or tables.shape[0] != B or tuple(lengths.shape) != (B,):
        raise ValueError(f"tables {tuple(tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match batch {B}")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("pools must start on a 16-byte boundary (16-byte async copies)")
    out = torch.empty_like(q)
    if B == 0 or QG == 0:
        return out
    P = tables.shape[1]
    pages, n_splits = split_plan(B, Hkv, P, bs, sm_count(dev.index or 0))
    if n_splits > _MAX_SPLITS:
        raise ValueError(f"{P} pages make {n_splits} splits, over {_MAX_SPLITS}")
    plan = launch_plan(QG, D, bs, k_pool.element_size(), pages)
    if plan["smem"] > _MAX_SMEM:
        raise ValueError(f"block size {bs} needs {plan['smem']} B of shared memory")
    if max(B * Hkv, plan["row_chunks"]) > 65_535:
        raise ValueError(f"grid of {B}x{Hkv} heads and {plan['row_chunks']} row chunks "
                         "exceeds the launch limit")
    ws = (torch.empty(B * Hkv * n_splits * QG * (D + 2), dtype=torch.float32, device=dev)
          if n_splits > 1 else out)
    kv_mul = 1.0 / kv_scale if kv_scale is not None else 1.0
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().paged_attn_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), ws.data_ptr(), B, Hkv, QG, D, bs, P, N,
        q_len, int(window), 1.0 / math.sqrt(D), kv_mul,
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pool.dtype], pages, n_splits,
        plan["rt"], plan["pages_per_stage"], plan["smem"], stream)
    if err:
        raise RuntimeError(f"paged_attn kernel launch failed: cudaError {err}")
    paged_attention.launches += 1
    return out


def paged_attention(q, k_pool, v_pool, tables, lengths, *, window: int = 0,
                    kv_scale=None) -> torch.Tensor:
    """q [B, H, D] (decode) or [B, Q, H, D] (Q-token tile) against pools
    [N, bs, H_kv, D] via tables [B, P] → output of q's shape and dtype.

    ``lengths [B]`` counts visible tokens per sequence *including every query
    token* (query ``j`` of Q sits at absolute position ``lengths - Q + j``
    and attends causally).  ``kv_scale`` set ⇒ pools hold fixed-point int8
    (values/kv_scale).
    """
    if q.ndim == 3:
        B, H, D = q.shape
        Q = 1
    else:
        B, Q, H, D = q.shape
    Hkv = k_pool.shape[2]
    if H % Hkv:
        raise ValueError(f"n_heads {H} not a multiple of n_kv_heads {Hkv}")
    G = H // Hkv
    if q.ndim == 3:
        qt = q.reshape(B, Hkv, G, D)
    else:
        # pack the Q tokens into the query tile: row q·G + g
        qt = q.reshape(B, Q, Hkv, G, D).permute(0, 2, 1, 3, 4).reshape(B, Hkv, Q * G, D)
    tables = tables.to(torch.int32)
    lengths = lengths.to(torch.int32)
    if q.is_cuda:
        o = paged_attn_cuda(qt.contiguous(), k_pool, v_pool, tables.contiguous(),
                            lengths.contiguous(), window=window, kv_scale=kv_scale,
                            q_len=Q)
    elif q.device.type == "cpu":
        o = paged_attn_ref(qt, k_pool, v_pool, tables, lengths, window=window,
                           kv_scale=kv_scale, q_len=Q)
    else:
        raise ValueError(f"paged_attention runs on CUDA or CPU, not {q.device}")
    if q.ndim == 3:
        return o.reshape(B, H, D)
    return o.reshape(B, Hkv, Q, G, D).permute(0, 2, 1, 3, 4).reshape(B, Q, H, D)


paged_attention.launches = 0
