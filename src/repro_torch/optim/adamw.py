"""AdamW with int8 block-quantized moments.

Both Adam moments are stored as int8 with one float32 scale per ``block``
elements of the trailing axis (blockwise dynamic quantization); the second
moment is quantized on the √v scale with ceil rounding, so quantization
only ever shrinks an update.  ``moment_dtype="float32"`` keeps exact
float32 moments.  Same rules and the same ops as the JAX package's
``optim/adamw.py``; trees are the port's dict/list trees of tensors, and
the update runs without autograd.

``adamw_update`` is the reference's functional form: it returns new
parameters and moments, so old and new are held at once.
``adamw_update_`` computes the same values and writes them into the
parameters and moments in place, a block of whole rows (rows of the
trailing axis) at a time, so its temporaries are a few float32 copies of
one block: every operation is elementwise or, for the int8 codec, blockwise
along the trailing axis, so the blocks give the functional form's values
bit for bit.  ``adamw_update_sharded_`` runs the in-place update on the
local shards of DTensor parameters and moments.  Under the profiler both
in-place updates run inside an ``optim/adamw`` range (``repro_torch.obs``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.core.quant import true_div
from repro_torch.tree import leaves_with_path, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "adamw_update_",
           "adamw_update_sharded_"]


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


def _corrections(step, cfg: AdamWConfig):
    """Bias corrections ``1 - b**t`` at the new step count ``t``."""
    t = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=t.device), t)
    c2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=t.device), t)
    return c1, c2


def _moments(g32, p32, m_old, v_old, decay: bool, lr, c1, c2, cfg: AdamWConfig):
    """One leaf's (or one block's) new first and second moments and new
    float32 parameters."""
    m = cfg.b1 * m_old + (1.0 - cfg.b1) * g32
    v = cfg.b2 * v_old + (1.0 - cfg.b2) * g32 * g32
    upd = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
    if decay:
        upd = upd + cfg.weight_decay * p32
    return m, v, p32 - lr * upd


@torch.no_grad()
def adamw_update(grads, params, state, lr, cfg: AdamWConfig = AdamWConfig()):
    """One AdamW step.  Returns (new_params, new_state).

    Decoupled weight decay; bias correction via step count.  Norm/bias
    params (ndim ≤ 1) are exempt from weight decay.
    """
    step = state["step"] + 1
    c1, c2 = _corrections(step, cfg)

    def leaf(g, p, mu, nu):
        g32 = g.to(torch.float32).reshape(p.shape if p.dim() else (1,))
        p32 = p.to(torch.float32).reshape(p.shape if p.dim() else (1,))
        m, v, newp = _moments(g32, p32, _load(mu, cfg, "m"), _load(nu, cfg, "v"),
                              p.dim() >= 2 and bool(cfg.weight_decay), lr, c1, c2, cfg)
        return _Updated(newp.reshape(p.shape).to(p.dtype), _store(m, cfg, "m"),
                        _store(v, cfg, "v"))

    out = tree_map(leaf, grads, params, state["mu"], state["nu"])
    return (tree_map(lambda o: o.p, out),
            {"mu": tree_map(lambda o: o.mu, out), "nu": tree_map(lambda o: o.nu, out),
             "step": step})


# Elements of one block of ``adamw_update_``: 2^24 float32 elements are 64
# MiB a temporary (the functional form holds ≈ 8 leaf-sized float32
# temporaries: 3.2 GB each on phi4-mini's [32, 3072, 8192] MLP leaf).
BLOCK_ELEMS = 1 << 24


def _update_leaf_(g, p, mu, nu, lr, c1, c2, cfg: AdamWConfig):
    """One leaf of ``adamw_update_``: ``p``, ``mu`` and ``nu`` written in
    place, a block of whole trailing-axis rows at a time."""
    decay = p.dim() >= 2 and bool(cfg.weight_decay)
    L = p.shape[-1] if p.dim() else 1
    rows = p.numel() // L
    p2, g2 = p.view(rows, L), g.reshape(rows, L)
    mu2 = {k: a.view(rows, -1) for k, a in mu.items()}
    nu2 = {k: a.view(rows, -1) for k, a in nu.items()}
    step = max(1, BLOCK_ELEMS // L)
    for lo in range(0, rows, step):
        sl = slice(lo, lo + step)
        mb = {k: a[sl] for k, a in mu2.items()}
        nb = {k: a[sl] for k, a in nu2.items()}
        m, v, newp = _moments(g2[sl].to(torch.float32), p2[sl].to(torch.float32),
                              _load(mb, cfg, "m"), _load(nb, cfg, "v"), decay,
                              lr, c1, c2, cfg)
        p2[sl].copy_(newp)
        for dst, src in ((mb, _store(m, cfg, "m")), (nb, _store(v, cfg, "v"))):
            for k, a in src.items():
                dst[k].copy_(a)


@obs.ranged("optim/adamw")
@torch.no_grad()
def adamw_update_(grads, params, state, lr, cfg: AdamWConfig = AdamWConfig()):
    """``adamw_update`` in place: writes the new parameters into ``params``
    and the new moments and step count into ``state``, and returns both.
    Each leaf is viewed as rows of its trailing axis and updated a block of
    whole rows at a time (at most ``BLOCK_ELEMS`` elements, one row at
    least); the values equal ``adamw_update``'s bit for bit."""
    state["step"].add_(1)
    c1, c2 = _corrections(state["step"], cfg)
    tree_map(lambda g, p, mu, nu: _update_leaf_(g, p, mu, nu, lr, c1, c2, cfg),
             grads, params, state["mu"], state["nu"])
    return params, state


def _local(x):
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


def _sharded_leaf_(g, p, mu, nu, lr, c1, c2, cfg: AdamWConfig):
    """``_update_leaf_`` on the local shards of DTensor ``g``, ``p`` and
    moments placed as ``launch.steps.optimizer_pspecs`` places them: ``q``
    as ``p``, an int8 moment's scales ``s`` as ``p`` but for the trailing
    axis — and, as in the reference, for any leading axis whose spec entry
    ``param_pspecs`` left implicit.  Every operation is elementwise or
    blockwise along the trailing axis, so each rank updates one block of
    the leaf: ``p``'s own shard, with the scales of its rows and blocks —
    or, where a shard boundary of the trailing axis cuts a codec block (a
    shard that is not a whole number of blocks, or less than one), that
    shard with its trailing axis gathered.  A moment leaf stored in other
    placements than the block's is written back from the block."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    if not isinstance(p, DTensor):
        return _update_leaf_(g, p, mu, nu, lr, c1, c2, cfg)
    mesh, place = p.device_mesh, tuple(p.placements)
    last = p.dim() - 1
    work = place
    if "s" in mu:
        local_shape, _ = compute_local_shape_and_global_offset(p.shape, mesh, place)
        if local_shape[-1] % cfg.block:
            work = tuple(Replicate() if isinstance(pl, Shard) and pl.dim == last else pl
                         for pl in place)
    leaves = [g, p, *mu.values(), *nu.values()]
    blocks = [a if tuple(a.placements) == work else a.redistribute(mesh, work)
              for a in leaves]
    n = len(mu)
    local = [b.to_local() for b in blocks]
    _update_leaf_(local[0], local[1], dict(zip(mu, local[2:2 + n])),
                  dict(zip(nu, local[2 + n:])), lr, c1, c2, cfg)
    for src, dst in zip(blocks[1:], leaves[1:]):
        if src is not dst:
            dst.to_local().copy_(src.redistribute(mesh, dst.placements).to_local())
    return None


@obs.ranged("optim/adamw")
@torch.no_grad()
def adamw_update_sharded_(grads, params, state, lr, cfg: AdamWConfig = AdamWConfig()):
    """``adamw_update_`` on DTensor params, gradients and moments (placed by
    ``optimizer_pspecs``), each rank updating its own shards in place
    (``_sharded_leaf_``); the step count is a replicated scalar and ``lr``
    a replicated or plain one."""
    step = _local(state["step"])
    step.add_(1)
    c1, c2 = _corrections(step, cfg)
    lr = _local(lr)
    tree_map(lambda g, p, mu, nu: _sharded_leaf_(g, p, mu, nu, lr, c1, c2, cfg),
             grads, params, state["mu"], state["nu"])
    return params, state
