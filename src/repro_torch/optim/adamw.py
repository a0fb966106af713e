"""AdamW with int8 block-quantized moments.

Both Adam moments are stored as int8 with one float32 scale per ``block``
elements of the trailing axis (blockwise dynamic quantization); the second
moment is quantized on the √v scale with ceil rounding, so quantization
only ever shrinks an update.  ``moment_dtype="float32"`` keeps exact
float32 moments.  Same rules and the same ops as the JAX package's
``optim/adamw.py``; trees are the port's dict/list trees of tensors, and
the update runs without autograd.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.quant import true_div
from repro_torch.tree import leaves_with_path, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update"]


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "int8"    # int8 | float32
    block: int = 128              # int8 quantization block (trailing axis)


# ---------------------------------------------------------------------------
# blockwise int8 moment codec
# ---------------------------------------------------------------------------

def _pad_to_block(x: torch.Tensor, block: int) -> torch.Tensor:
    pad = (-x.shape[-1]) % block
    return F.pad(x, (0, pad)) if pad else x


def _quant_block(x: torch.Tensor, block: int, kind: str = "m") -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 [..., L] → (int8 [..., L], float32 scales [..., ceil(L/block)]).
    ``kind='m'`` rounds to nearest; ``kind='v'`` quantizes √v with ceil."""
    orig_last = x.shape[-1]
    if kind == "v":
        x = torch.sqrt(torch.clamp_min(x, 0.0))
    xp = _pad_to_block(x, block)
    xb = xp.reshape(*xp.shape[:-1], xp.shape[-1] // block, block)
    scale = true_div(xb.abs().amax(dim=-1), 127.0)                 # [..., nb]
    y = xb / torch.clamp_min(scale[..., None], 1e-30)
    q = torch.where(scale[..., None] > 0.0,
                    torch.ceil(y) if kind == "v" else torch.round(y), torch.zeros_like(y))
    q = torch.clamp(q, -127, 127).to(torch.int8)
    q = q.reshape(*xp.shape)[..., :orig_last]
    return q, scale.to(torch.float32)


def _dequant_block(q: torch.Tensor, scale: torch.Tensor, block: int,
                   kind: str = "m") -> torch.Tensor:
    qp = _pad_to_block(q.to(torch.float32), block)
    xb = qp.reshape(*qp.shape[:-1], qp.shape[-1] // block, block)
    x = (xb * scale[..., None]).reshape(*qp.shape)[..., :q.shape[-1]]
    if kind == "v":
        x = x * x
    return x


# ---------------------------------------------------------------------------
# init / update
# ---------------------------------------------------------------------------

def _moment_zero(p: torch.Tensor, cfg: AdamWConfig):
    if cfg.moment_dtype == "float32":
        return {"q": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}
    nb = -(-p.shape[-1] // cfg.block) if p.dim() else 1
    shape = tuple(p.shape) if p.dim() else (1,)
    return {
        "q": torch.zeros(shape, dtype=torch.int8, device=p.device),
        "s": torch.zeros((*shape[:-1], nb), dtype=torch.float32, device=p.device),
    }


def adamw_init(params, cfg: AdamWConfig = AdamWConfig()) -> Dict[str, Any]:
    _, _, some = next(leaves_with_path(params))
    return {
        "mu": tree_map(lambda p: _moment_zero(p, cfg), params),
        "nu": tree_map(lambda p: _moment_zero(p, cfg), params),
        "step": torch.zeros((), dtype=torch.int32, device=some.device),
    }


def _load(m, cfg: AdamWConfig, kind: str = "m") -> torch.Tensor:
    if cfg.moment_dtype == "float32":
        return m["q"]
    return _dequant_block(m["q"], m["s"], cfg.block, kind)


def _store(x: torch.Tensor, cfg: AdamWConfig, kind: str = "m"):
    if cfg.moment_dtype == "float32":
        return {"q": x}
    q, s = _quant_block(x, cfg.block, kind)
    return {"q": q, "s": s}


class _Updated:
    """One leaf's new (param, first moment, second moment)."""
    __slots__ = ("p", "mu", "nu")

    def __init__(self, p, mu, nu):
        self.p, self.mu, self.nu = p, mu, nu


@torch.no_grad()
def adamw_update(grads, params, state, lr, cfg: AdamWConfig = AdamWConfig()):
    """One AdamW step.  Returns (new_params, new_state).

    Decoupled weight decay; bias correction via step count.  Norm/bias
    params (ndim ≤ 1) are exempt from weight decay.
    """
    step = state["step"] + 1
    t = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=t.device), t)
    c2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=t.device), t)

    def leaf(g, p, mu, nu):
        g32 = g.to(torch.float32).reshape(p.shape if p.dim() else (1,))
        p32 = p.to(torch.float32).reshape(p.shape if p.dim() else (1,))
        m = cfg.b1 * _load(mu, cfg, "m") + (1.0 - cfg.b1) * g32
        v = cfg.b2 * _load(nu, cfg, "v") + (1.0 - cfg.b2) * g32 * g32
        upd = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        if p.dim() >= 2 and cfg.weight_decay:
            upd = upd + cfg.weight_decay * p32
        newp = (p32 - lr * upd).reshape(p.shape).to(p.dtype)
        return _Updated(newp, _store(m, cfg, "m"), _store(v, cfg, "v"))

    out = tree_map(leaf, grads, params, state["mu"], state["nu"])
    return (tree_map(lambda o: o.p, out),
            {"mu": tree_map(lambda o: o.mu, out), "nu": tree_map(lambda o: o.nu, out),
             "step": step})
