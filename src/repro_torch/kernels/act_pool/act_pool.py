"""Binding of the CUDA activation + pooling kernel (``csrc/act_pool.cu``).

``act_pool_cuda`` launches it on CUDA tensors and raises on anything the
kernel does not take; ``act_pool_cuda.launches`` counts its launches.  The
launcher sizes the kernel's flat grid itself; ``launch_plan`` is its plan in
Python, for the tests, and ``kernel_plan`` asks the library for its own.
The library is built with ``nvcc`` on the first launch
(``kernels/build.py``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

__all__ = ["act_pool_cuda", "launch_plan", "kernel_plan", "SOURCE", "ACTS", "POOL_KINDS"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "act_pool.cu"

ACTS = ("relu", "tanh")
POOL_KINDS = ("max", "avg")
# kThreads, kUnroll and kCtasPerSm of csrc/act_pool.cu
THREADS = 256
UNROLL = 2
CTAS_PER_SM = 4


@functools.cache
def _library() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load(SOURCE)
    fn = lib.act_pool_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.act_pool_plan
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    return lib


def launch_plan(shape, pool: int, aligned: bool, n_sm: int) -> dict:
    """The launcher's grid (``plan`` in csrc/act_pool.cu) for an int32
    [B, H, W, C] input: items of four channels (``vec``) when C % 4 == 0 and
    the input and output are 16-byte ``aligned``, else of one; CTAs of
    ``THREADS`` threads that take ``UNROLL`` items each a pass, at most
    ``CTAS_PER_SM`` a streaming multiprocessor (all resident); ``passes`` of
    the grid-stride loop."""
    B, H, W, C = shape
    vec = C % 4 == 0 and aligned
    items = B * (H // pool) * (W // pool) * C // (4 if vec else 1)
    per_cta = THREADS * UNROLL
    grid = max(1, min(-(-items // per_cta), n_sm * CTAS_PER_SM))
    return {"vec": vec, "items": items, "grid": grid,
            "passes": -(-items // (grid * per_cta))}


def kernel_plan(shape, pool: int, aligned: bool, n_sm: int) -> dict:
    """``launch_plan`` as the library computes it, to hold the two equal."""
    out = (ctypes.c_longlong * 4)()
    err = _library().act_pool_plan(*shape, pool, int(aligned), n_sm, out)
    if err:
        raise ValueError(f"act_pool plan refused shape {tuple(shape)}, pool {pool}: "
                         f"cudaError {err}")
    return {"vec": bool(out[0]), "items": out[1], "grid": out[2], "passes": out[3]}


def act_pool_cuda(x: torch.Tensor, *, pool: int, act: str, pool_kind: str) -> torch.Tensor:
    """x int32 [B, H, W, C] on the card → int32 [B, H/pool, W/pool, C].

    Shapes, dtype and options are validated by ``ops.act_pool``; this checks
    only what the kernel itself assumes, and the launcher refuses anything
    else with ``cudaErrorInvalidValue``."""
    if not x.is_cuda or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous CUDA tensor, got {x.device}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"shape {tuple(x.shape)} outside the kernel's int32 indexing")
    B, H, W, C = x.shape
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
