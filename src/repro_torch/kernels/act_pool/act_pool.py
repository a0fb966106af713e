"""Binding of the CUDA activation + pooling kernel (``csrc/act_pool.cu``).

``act_pool_cuda`` launches it on CUDA tensors and raises on anything the
kernel does not take; ``act_pool_cuda.launches`` counts its launches.  The
library is built with ``nvcc`` on the first launch (``kernels/build.py``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

__all__ = ["act_pool_cuda", "SOURCE", "ACTS", "POOL_KINDS"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "act_pool.cu"

ACTS = ("relu", "tanh")
POOL_KINDS = ("max", "avg")


@functools.cache
def _library() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load(SOURCE)
    fn = lib.act_pool_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def act_pool_cuda(x: torch.Tensor, *, pool: int, act: str, pool_kind: str) -> torch.Tensor:
    """x int32 [B, H, W, C] on the card → int32 [B, H/pool, W/pool, C].

    Shapes, dtype and options are validated by ``ops.act_pool``; this checks
    only what the kernel itself assumes, and the launcher refuses anything
    else with ``cudaErrorInvalidValue``."""
    if not x.is_cuda or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous CUDA tensor, got {x.device}")
    B, H, W, C = x.shape
    if x.numel() >= 2 ** 31 or -(-(W // pool) * C // 256) > 65535:
        raise ValueError(f"shape {tuple(x.shape)} outside the kernel's int32 indexing")
    out = torch.empty((B, H // pool, W // pool, C), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _library().act_pool_launch(x.data_ptr(), out.data_ptr(), B, H, W, C, pool,
                                     ACTS.index(act), POOL_KINDS.index(pool_kind), stream)
    if err:
        raise RuntimeError(f"act_pool kernel launch failed: cudaError {err}")
    act_pool_cuda.launches += 1
    return out


act_pool_cuda.launches = 0
