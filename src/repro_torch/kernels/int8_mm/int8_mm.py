"""Binding of the CUDA int8 GEMM (``csrc/int8_mm.cu``).

``int8_mm_cuda`` launches it on CUDA tensors and raises on anything the
kernel does not take; ``int8_mm_cuda.launches`` counts its launches.  The
library is built with ``nvcc`` on the first launch (``kernels/build.py``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

__all__ = ["int8_mm_cuda", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "int8_mm.cu"


@functools.cache
def _library() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load(SOURCE)
    fn = lib.int8_mm_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def int8_mm_cuda(a, w, scale_a, scale_w) -> torch.Tensor:
    """a int8 [M, K] · w int8 [K, N], exact int32 accumulate, then
    ``acc · (scale_a[m] · scale_w[n])`` → float32 [M, N]."""
    dev = a.device
    for name, t in (("a", a), ("w", w), ("scale_a", scale_a), ("scale_w", scale_w)):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError(f"operands must be int8, got {a.dtype}/{w.dtype}")
    if scale_a.dtype != torch.float32 or scale_w.dtype != torch.float32:
        raise ValueError(f"scales must be float32, got {scale_a.dtype}/{scale_w.dtype}")
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(w.shape)} do not chain")
    M, K = a.shape
    N = w.shape[1]
    if tuple(scale_a.shape) != (M,) or tuple(scale_w.shape) != (N,):
        raise ValueError(f"scales {tuple(scale_a.shape)}/{tuple(scale_w.shape)} do not "
                         f"match [{M}]/[{N}]")
    if max(M * K, K * N, M * N) >= 2 ** 31:
        raise ValueError(f"shape {M}x{K}x{N} outside the kernel's int32 indexing")
    if K == 0:
        return torch.zeros((M, N), dtype=torch.float32, device=dev)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0 or N == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().int8_mm_launch(a.data_ptr(), w.data_ptr(), scale_a.data_ptr(),
                                    scale_w.data_ptr(), out.data_ptr(), M, N, K, stream)
    if err:
        raise RuntimeError(f"int8_mm kernel launch failed: cudaError {err}")
    int8_mm_cuda.launches += 1
    return out


int8_mm_cuda.launches = 0
