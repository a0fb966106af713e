"""Binding of the CUDA stochastic-MAC kernel (``csrc/sc_mac.cu``).

``sc_mac_cuda`` launches it on CUDA tensors and raises on anything the
kernel does not take; ``sc_mac_cuda.launches`` counts its launches.  The
library is built with ``nvcc`` on the first launch (``kernels/build.py``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

__all__ = ["sc_mac_cuda", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "sc_mac.cu"

_DTYPE_CODE = {torch.uint8: 0, torch.int32: 1}
_MAX_LEVELS = 23           # tile depth the kernel's level stack holds
_MAX_SMEM = 232_448        # bytes of shared memory one H100 block may use


@functools.cache
def _library() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load(SOURCE)
    fn = lib.sc_mac_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
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
    smem = 4 * (2 * L * W + bk_log * W)
    if smem > _MAX_SMEM:
        raise ValueError(f"LUTs of {L}x{W} words need {smem} B of shared memory")
    out = torch.empty((M, N), dtype=torch.int32, device=dev)
    if M == 0 or N == 0:
        return out
    n_tiles = -(-K // block_k)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().sc_mac_launch(
        a.data_ptr(), w.data_ptr(), lut_a.data_ptr(), lut_w.data_ptr(), selects.data_ptr(),
        out.data_ptr(), M, N, K, L, W.bit_length() - 1, bk_log, n_tiles,
        _DTYPE_CODE[a.dtype], stream)
    if err:
        raise RuntimeError(f"sc_mac kernel launch failed: cudaError {err}")
    sc_mac_cuda.launches += 1
    return out


sc_mac_cuda.launches = 0
