"""Binding of the CUDA int8 GEMM (``csrc/int8_mm.cu``).

``int8_mm_cuda`` launches it on CUDA tensors and raises on anything the
kernel does not take; ``int8_mm_cuda.launches`` counts its launches.  The
library is built with ``nvcc`` on the first launch (``kernels/build.py``).

The kernel's tensor cores take both operands K-major, with rows a multiple
of 16 bytes for TMA: :func:`k_major_operands` has ``wᵀ`` [N, K̂] written
(and pads ``a`` where it must), ``K̂ = K`` rounded up to 16 with zero
columns, which leave the int32 sums unchanged.  It is part of every call;
on the card a small transpose kernel writes ``wᵀ``, on the CPU PyTorch
does, where the tests hold the result against the plain version.  A call
on the card is two kernels: the transpose, then the GEMM.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

__all__ = ["int8_mm_cuda", "k_major_operands", "check_shapes", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "int8_mm.cu"


@functools.cache
def _library() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load(SOURCE)
    fn = lib.int8_mm_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.int8_transpose_pad_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def check_shapes(M: int, K: int, N: int) -> int:
    """K̂ for an [M, K] · [K, N] product, or ValueError for a shape the
    kernel does not take."""
    k_hat = -(-K // 16) * 16
    if max(M * k_hat, k_hat * N, M * N) >= 2 ** 31:
        raise ValueError(f"shape {M}x{K}x{N} outside the kernel's int32 indexing")
    return k_hat


def k_major_operands(a: torch.Tensor, w: torch.Tensor):
    """``(a_k [M, K̂], w_t [N, K̂])``: ``a`` as it is when ``K % 16 == 0`` and
    it starts on a 16-byte boundary, else zero-padded; ``w_t`` is ``wᵀ``,
    zero-padded to K̂ columns, written by the transpose kernel for a CUDA
    ``w`` and by PyTorch for a CPU one.  ``a_k @ w_t.T == a @ w`` exactly."""
    (M, K), N = a.shape, w.shape[1]
    k_hat = check_shapes(M, K, N)
    if k_hat == K and a.data_ptr() % 16 == 0:
        a_k = a
    else:
        a_k = a.new_zeros((M, k_hat))
        a_k[:, :K] = a
    if w.is_cuda:
        w_t = torch.empty((N, k_hat), dtype=w.dtype, device=w.device)
        if N and K:
            err = _library().int8_transpose_pad_launch(
                w.data_ptr(), w_t.data_ptr(), K, N, k_hat,
                torch.cuda.current_stream(w.device).cuda_stream)
            if err:
                raise RuntimeError(f"int8_mm transpose kernel launch failed: cudaError {err}")
    elif k_hat == K:
        w_t = w.t().contiguous()
    else:
        w_t = w.new_zeros((N, k_hat))
        w_t[:, :K] = w.t()
    return a_k, w_t


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
    check_shapes(M, K, N)
    if K == 0:
        return torch.zeros((M, N), dtype=torch.float32, device=dev)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0 or N == 0:
        return out
    a_k, w_t = k_major_operands(a, w)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().int8_mm_launch(a_k.data_ptr(), w_t.data_ptr(), scale_a.data_ptr(),
                                    scale_w.data_ptr(), out.data_ptr(), M, N, a_k.shape[1],
                                    stream)
    if err == -1:
        raise RuntimeError("int8_mm: the TMA tensor maps could not be encoded")
    if err:
        raise RuntimeError(f"int8_mm kernel launch failed: cudaError {err}")
    int8_mm_cuda.launches += 1
    return out


int8_mm_cuda.launches = 0
