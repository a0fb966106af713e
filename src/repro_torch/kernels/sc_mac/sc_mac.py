"""Binding of the CUDA stochastic-MAC kernel (``csrc/sc_mac.cu``).

``sc_mac_cuda`` launches it on CUDA tensors and raises on anything the
kernel does not take; ``sc_mac_cuda.launches`` counts its calls (one a
call, also when the launch zeroes the output for a split K first).
``sc_plan`` cuts the work into CTAs from the shapes alone.  The library is
built with ``nvcc`` on the first launch (``kernels/build.py``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.paged_attn.ops import sm_count

__all__ = ["sc_mac_cuda", "sc_plan", "smem_bytes", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "sc_mac.cu"

_DTYPE_CODE = {torch.uint8: 0, torch.int32: 1}
_MAX_LEVELS = 23           # tree depth the kernel's masks and selects hold
_MAX_SMEM = 232_448        # bytes of shared memory one H100 block may use
CHUNK = 32                 # leaves a chunk: the kernel's K step and the unit of a split
_NN = 4                    # columns a thread
_MIN_THREADS, _MAX_THREADS = 128, 256
_CTAS_PER_SM = 4           # CTAs of 256 threads a plan aims at, per SM


def sc_plan(M: int, N: int, K: int, bk: int, W: int, n_sm: int) -> dict:
    """Launch plan for ``a [M, K] @ w [K, N]`` in trees of ``bk`` leaves,
    streams of ``W`` words, on a card of ``n_sm`` SMs.

    The tile's rows come from the smaller operand (``swap``: w's columns
    when M > N), ``mm`` of them a CTA (2 for one or two rows, else 4); its
    ``nt`` columns from the larger, 4 a thread, with W/2 threads (a word
    pair each) a column and 128 to 256 threads a CTA.  K is cut into chunks
    of 32 leaves and the chunks into ``n_splits`` runs of
    ``chunks_per_split`` so that the grid holds about four CTAs of 256
    threads an SM.  A popcount closes every ``group`` leaves (32, or 8 or 2
    for shorter trees), which divides both ``bk`` and a chunk.  A function
    of the shapes alone: it reads no tensor, so the host never waits on
    the device."""
    swap = M > N
    rows, cols = (N, M) if swap else (M, N)
    half = max(W, 2) // 2                    # one-word streams run padded to two
    mm = 2 if rows <= 2 else 4
    cs = max(1, _MIN_THREADS // half)
    while cs * half < _MAX_THREADS and cs * _NN < cols:
        cs *= 2
    nt, threads = cs * _NN, cs * half
    row_blocks, col_blocks = -(-rows // mm), -(-cols // nt)
    chunks = -(-K // CHUNK)
    tiles = row_blocks * col_blocks
    want = -(-_CTAS_PER_SM * n_sm * _MAX_THREADS // (threads * tiles))
    per = -(-chunks // max(1, min(want, chunks)))
    n_splits = -(-chunks // per)
    return dict(swap=swap, rows=rows, cols=cols, mm=mm, cs=cs, nt=nt, threads=threads,
                row_blocks=row_blocks, col_blocks=col_blocks, chunks=chunks,
                chunks_per_split=per, n_splits=n_splits,
                group=32 if bk >= 32 else 8 if bk >= 8 else 2,
                ctas=tiles * n_splits)


def smem_bytes(L: int, W: int, rep: int, depth: int, nt: int, mm: int) -> int:
    """Shared memory of one CTA (``Layout`` in the source): B's LUT in
    ``rep`` copies a row, S's LUT, the leaf masks of a chunk, the selects,
    and two stages each of B's 16-bit levels and S's masked streams."""
    def a16(x):
        return -(-x // 16) * 16
    return (a16(L * rep * W * 4) + a16(L * W * 4) + a16(CHUNK * W * 4) + a16(depth * W * 4)
            + 2 * a16(CHUNK * nt * 2) + 2 * a16((W // 2) * (CHUNK * mm * 2 + 2) * 4))


@functools.cache
def _library() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load(SOURCE)
    fn = lib.sc_mac_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def sc_mac_cuda(a, w, lut_a, lut_w, selects, *, block_k: int) -> torch.Tensor:
    """Popcounts of the MAC array: a [M, K], w [K, N] (uint8 or int32, one
    dtype), LUTs int32 [L, W], selects int32 [depth, W] → int32 [M, N],
    summed over ceil(K / block_k) MUX trees of ``block_k`` leaves each."""
    dev = a.device
    for name, t in (("a", a), ("w", w), ("lut_a", lut_a), ("lut_w", lut_w),
                    ("selects", selects)):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.dtype not in _DTYPE_CODE or w.dtype != a.dtype:
        raise ValueError(f"operand dtypes {a.dtype}/{w.dtype}: need one of "
                         f"{tuple(_DTYPE_CODE)}")
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(w.shape)} do not chain")
    M, K = a.shape
    N = w.shape[1]
    for name, t in (("lut_a", lut_a), ("lut_w", lut_w), ("selects", selects)):
        if t.dtype != torch.int32 or t.dim() != 2:
            raise ValueError(f"{name} must be a 2-D int32 table, got {t.dtype} {tuple(t.shape)}")
    L, W = lut_a.shape
    if lut_w.shape != lut_a.shape or selects.shape[1] != W:
        raise ValueError(f"LUT/select shapes {tuple(lut_a.shape)}/{tuple(lut_w.shape)}/"
                         f"{tuple(selects.shape)} disagree")
    if W & (W - 1) or not 1 <= W <= 32:
        raise ValueError(f"{W} words a stream: the kernel takes a power of two up to 32")
    bk_log = block_k.bit_length() - 1
    if block_k < 2 or 1 << bk_log != block_k or bk_log > _MAX_LEVELS:
        raise ValueError(f"block_k {block_k} must be a power of two in [2, 2^{_MAX_LEVELS}]")
    if selects.shape[0] < bk_log:
        raise ValueError(f"{selects.shape[0]} select streams for a tree of depth {bk_log}")
    if K < 1 or max(M * K, K * N, M * N * W) >= 2 ** 31:
        raise ValueError(f"shape {M}x{K}x{N} outside the kernel's int32 indexing")
    out = torch.empty((M, N), dtype=torch.int32, device=dev)
    if M == 0 or N == 0:
        return out
    plan = sc_plan(M, N, K, block_k, W, sm_count(dev.index or 0))
    Wk = max(W, 2)
    smem = smem_bytes(L, Wk, 1, bk_log, plan["nt"], plan["mm"])
    if smem > _MAX_SMEM:
        raise ValueError(f"LUTs of {L}x{W} words need {smem} B of shared memory")
    rep = 32 // Wk
    if smem_bytes(L, Wk, rep, bk_log, plan["nt"], plan["mm"]) > _MAX_SMEM:
        rep = 1                              # one copy of each row: gathers may conflict
    if W == 1:                               # a zero second word adds no bits
        lut_a, lut_w, selects = (torch.nn.functional.pad(t, (0, 1)).contiguous()
                                 for t in (lut_a, lut_w, selects[:bk_log]))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().sc_mac_launch(
        a.data_ptr(), w.data_ptr(), lut_a.data_ptr(), lut_w.data_ptr(), selects.data_ptr(),
        out.data_ptr(), M, N, K, L, Wk.bit_length() - 1, bk_log, _DTYPE_CODE[a.dtype],
        int(plan["swap"]), plan["mm"], plan["cs"], plan["chunks_per_split"], plan["n_splits"],
        rep, plan["group"], stream)
    if err:
        raise RuntimeError(f"sc_mac kernel launch failed: cudaError {err}")
    sc_mac_cuda.launches += 1
    return out


sc_mac_cuda.launches = 0
