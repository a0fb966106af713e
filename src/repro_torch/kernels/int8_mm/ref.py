"""Plain PyTorch version of the int8 GEMM + dequant kernel."""
from __future__ import annotations

import torch

from repro_torch.core.stochastic import int_matmul

__all__ = ["int8_mm_ref"]


def int8_mm_ref(a, w, scale_a, scale_w) -> torch.Tensor:
    """int8 [M,K] · int8 [K,N], exact int32 accumulate, float32 dequant."""
    acc = int_matmul(a, w)
    return acc.to(torch.float32) * (scale_a.reshape(-1, 1) * scale_w.reshape(1, -1))
