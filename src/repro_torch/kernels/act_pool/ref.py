"""Plain PyTorch version of the fused 8-bit activation + pooling kernel, and
the CUDA kernel's own algorithm in plain PyTorch (``act_pool_kernel_ref``,
for the CPU tests; no path runs it)."""
from __future__ import annotations

import torch

from repro_torch.core.quant import true_div

__all__ = ["act_pool_ref", "act_pool_kernel_ref", "tanh8", "tanh_table", "TANH_TABLE_LEN"]

# the 8-bit tanh is 255 from x = 222 on and 0 up to x = 0: a table of
# x = 0..221 (kTableLen of csrc/act_pool.cu) holds every other value
TANH_TABLE_LEN = 222


def tanh8(x: torch.Tensor) -> torch.Tensor:
    """The 8-bit tanh of int32 ``x``: ``clip(round(255·tanh(x/64)), 0, 255)``.

    Computed in float64.  No integer x puts 255·tanh(x/64) within 1.7e-3 of
    a half-integer, so float32, as in the JAX package, gives the same
    values; but the CPU build of PyTorch 2.13 has returned 255 for x = 221
    (and 180 for x = 56) from float32 ``torch.tanh`` on its first
    multi-threaded call in a process."""
    return torch.clamp(torch.round(255.0 * torch.tanh(x.double() / 64.0)),
                       0, 255).to(torch.int32)


def tanh_table(device=None) -> torch.Tensor:
    """int32 [TANH_TABLE_LEN]: the 8-bit tanh of x = 0..221."""
    return tanh8(torch.arange(TANH_TABLE_LEN, dtype=torch.int32, device=device))


def act_pool_ref(x: torch.Tensor, pool: int = 2, act: str = "relu",
                 pool_kind: str = "max") -> torch.Tensor:
    """int32 NHWC → 8-bit activation then p×p pooling (stride p).

    ``relu`` clips to 0..255; ``tanh`` is ``clip(round(255·tanh(x/64)), 0,
    255)``.  ``avg`` is the rounded mean (half to even, like ``jnp.round``),
    divided as an IEEE division on every device (``true_div``)."""
    B, H, W, C = x.shape
    r = tanh8(x) if act == "tanh" else torch.clamp(x, 0, 255)
    r = r.reshape(B, H // pool, pool, W // pool, pool, C)
    if pool_kind == "avg":
        total = r.sum(dim=(2, 4)).float()
        return torch.round(true_div(total, pool * pool)).to(torch.int32)
    return r.amax(dim=(2, 4))


def act_pool_kernel_ref(x: torch.Tensor, pool: int = 2, act: str = "relu",
                        pool_kind: str = "max") -> torch.Tensor:
    """The kernel's algorithm (``csrc/act_pool.cu``) → the same function as
    ``act_pool_ref``: the max kinds take the int32 max of the raw window and
    activate it once (both activations are monotone non-decreasing); the
    avg kind activates every input, the tanh read from ``tanh_table`` (0
    below it, 255 past it), and divides the int32 sum by p² in float32."""
    B, H, W, C = x.shape
    win = x.reshape(B, H // pool, pool, W // pool, pool, C)
    if pool_kind == "max":
        top = win.amax(dim=(2, 4))
        return tanh8(top) if act == "tanh" else torch.clamp(top, 0, 255)
    if act == "tanh":
        table = tanh_table(x.device)
        r = torch.where(win >= TANH_TABLE_LEN, 255,
                        table[win.clamp(0, TANH_TABLE_LEN - 1).long()])
    else:
        r = torch.clamp(win, 0, 255)
    total = r.sum(dim=(2, 4), dtype=torch.int32).float()
    return torch.round(true_div(total, pool * pool)).to(torch.int32)
