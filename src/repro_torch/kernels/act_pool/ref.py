"""Plain PyTorch version of the fused 8-bit activation + pooling kernel."""
from __future__ import annotations

import torch

from repro_torch.core.quant import true_div

__all__ = ["act_pool_ref"]


def act_pool_ref(x: torch.Tensor, pool: int = 2, act: str = "relu",
                 pool_kind: str = "max") -> torch.Tensor:
    """int32 NHWC → 8-bit activation then p×p pooling (stride p).

    ``relu`` clips to 0..255; ``tanh`` is ``clip(round(255·tanh(x/64)), 0,
    255)``.  ``avg`` is the rounded mean (half to even, like ``jnp.round``),
    divided as an IEEE division on every device (``true_div``)."""
    B, H, W, C = x.shape
    if act == "tanh":
        r = torch.clamp(torch.round(255.0 * torch.tanh(x.float() / 64.0)),
                        0, 255).to(torch.int32)
    else:
        r = torch.clamp(x, 0, 255)
    r = r.reshape(B, H // pool, pool, W // pool, pool, C)
    if pool_kind == "avg":
        total = r.sum(dim=(2, 4)).float()
        return torch.round(true_div(total, pool * pool)).to(torch.int32)
    return r.amax(dim=(2, 4))
