"""Entry point of the fused 8-bit activation + pooling block (the paper's
§IV-B.2 CMOS add-on logic after the popcount):

* ``act_pool(x, pool=2, act="relu", pool_kind="max")`` — the counterpart of
  the JAX ``act_pool``: int32 NHWC popcount-domain map in, 8-bit activated
  and p×p pooled int32 map out.

A CUDA tensor runs the kernel (``csrc/act_pool.cu``) — it launches or
raises, it never falls back; a CPU tensor runs the plain version
(``ref.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.act_pool.act_pool import ACTS, POOL_KINDS, act_pool_cuda
from repro_torch.kernels.act_pool.ref import act_pool_ref

__all__ = ["act_pool"]


def act_pool(x: torch.Tensor, *, pool: int = 2, act: str = "relu",
             pool_kind: str = "max") -> torch.Tensor:
    """int32 [B,H,W,C] → int32 [B,H/p,W/p,C]: 8-bit act then p×p pooling.

    ``act``: relu | tanh (8-bit LUT form); ``pool_kind``: max | avg."""
    if act not in ACTS or pool_kind not in POOL_KINDS:
        raise ValueError(f"act {act!r} / pool_kind {pool_kind!r}: need one of "
                         f"{ACTS} / {POOL_KINDS}")
    if x.dim() != 4 or x.dtype != torch.int32:
        raise ValueError(f"x must be int32 [B, H, W, C], got {x.dtype} {tuple(x.shape)}")
    H, W = x.shape[1], x.shape[2]
    if pool < 1 or H % pool or W % pool:
        raise ValueError(f"H={H}, W={W} must be multiples of pool={pool}")
    if x.is_cuda:
        return act_pool_cuda(x.contiguous(), pool=pool, act=act, pool_kind=pool_kind)
    if x.device.type != "cpu":
        raise ValueError(f"act_pool runs on CUDA or CPU, not {x.device}")
    return act_pool_ref(x, pool, act, pool_kind)
