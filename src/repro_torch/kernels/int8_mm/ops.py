"""Entry points of the int8 GEMM:

* ``int8_mm_fused(a, w, scale_a, scale_w)`` — the counterpart of the JAX
  ``int8_mm_pallas``: quantized operands in, dequantized float32 out;
* ``int8_matmul(x, w)`` — the end-to-end op: symmetric per-row int8
  quantization of ``x``, per-column of ``w``, then the GEMM.

CUDA tensors run the kernel (``csrc/int8_mm.cu``) — it launches or raises,
it never falls back; CPU tensors run the plain version (``ref.py``).
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import true_div
from repro_torch.kernels.int8_mm.int8_mm import int8_mm_cuda
from repro_torch.kernels.int8_mm.ref import int8_mm_ref

__all__ = ["int8_mm_fused", "int8_matmul"]


def int8_mm_fused(a, w, scale_a, scale_w) -> torch.Tensor:
    """a int8 [M,K], w int8 [K,N], scales float32 [M]/[N] → float32 [M,N]."""
    scale_a = scale_a.reshape(-1).to(torch.float32)
    scale_w = scale_w.reshape(-1).to(torch.float32)
    if a.is_cuda:
        return int8_mm_cuda(a.contiguous(), w.contiguous(), scale_a.contiguous(),
                            scale_w.contiguous())
    if a.device.type != "cpu":
        raise ValueError(f"int8_mm runs on CUDA or CPU, not {a.device}")
    return int8_mm_ref(a, w, scale_a, scale_w)


def int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """float [M,K] @ float [K,N] through symmetric int8 quantization
    (per row of x, per column of w)."""
    amax_x = torch.clamp_min(x.abs().amax(dim=1, keepdim=True), 1e-12)
    amax_w = torch.clamp_min(w.abs().amax(dim=0, keepdim=True), 1e-12)
    sx = true_div(amax_x, 127.0).to(torch.float32)
    sw = true_div(amax_w, 127.0).to(torch.float32)
    xq = torch.clamp(torch.round(x / sx), -127, 127).to(torch.int8)
    wq = torch.clamp(torch.round(w / sw), -127, 127).to(torch.int8)
    return int8_mm_fused(xq, wq, sx[:, 0], sw[0, :])
