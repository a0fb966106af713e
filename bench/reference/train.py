"""The plain reference of the training step: the loss and its gradients in
float32, and AdamW with the blockwise int8 moment codec, written here
from the optimizer's description.

Loss: the mean over every token of logsumexp(logits) - logits[label].
Each layer runs under ``torch.utils.checkpoint`` and the head and loss in
blocks of rows, so that a full-depth model fits beside its float32
gradients.

AdamW (decoupled weight decay, bias correction by the step count t):
  m = b1 m + (1 - b1) g,  v = b2 v + (1 - b2) g²,
  p ← p - lr ((m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) + wd p),
the decay applied to every leaf whose stacked layout has two axes or more
(the final norm's gain alone is exempt), with the update computed from the
new float32 moments before they are stored.  The moments are stored as
int8 with one float32 scale per block of 128 elements of the trailing
axis: m as round(m / s), s = max|m| / 127; v as ceil(sqrt(v) / s) on the
sqrt(v) scale, so a stored moment only ever shrinks an update.  Parameters
are stored in their configured type (bfloat16 projections, float32 norm
gains): each update is rounded to it.  The learning rate warms up linearly
from base/warmup at step 0 to base, then decays by a cosine to a tenth of
base at 10,000 steps.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.utils.checkpoint as ckpt

from reference import model as ref
from reference.weights import dims, leaf_specs

__all__ = ["AdamW", "lr_at", "leaves", "loss_and_grads", "quantize", "dequantize",
           "train_steps"]


def lr_at(step: int, base: float, warmup: int, total: int = 10_000) -> torch.Tensor:
    s = torch.tensor(float(step), dtype=torch.float32)
    if step < warmup:
        return base * ((s + 1.0) / max(warmup, 1))
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    return base * (0.1 + 0.9 * 0.5 * (1.0 + torch.cos(math.pi * prog)))


def quantize(x: torch.Tensor, kind: str, block: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 [..., n] → (int8 codes [..., n], float32 scales [..., ceil(n / block)])."""
    if kind == "v":
        x = torch.sqrt(torch.clamp_min(x, 0.0))
    n = x.shape[-1]
    pad = (-n) % block
    xb = torch.nn.functional.pad(x, (0, pad)).reshape(*x.shape[:-1], -1, block)
    s = xb.abs().amax(-1) / 127.0
    y = xb / torch.clamp_min(s[..., None], 1e-30)
    q = torch.ceil(y) if kind == "v" else torch.round(y)
    q = torch.where(s[..., None] > 0, q, torch.zeros_like(q)).clamp(-127, 127)
    return q.to(torch.int8).reshape(*x.shape[:-1], -1)[..., :n], s


def dequantize(q: torch.Tensor, s: torch.Tensor, kind: str, block: int = 128) -> torch.Tensor:
    n = q.shape[-1]
    pad = (-n) % block
    qb = torch.nn.functional.pad(q.float(), (0, pad)).reshape(*q.shape[:-1], -1, block)
    x = (qb * s[..., None]).reshape(*q.shape[:-1], -1)[..., :n]
    return x * x if kind == "v" else x


def leaves(w: Dict[str, torch.Tensor], cfg: Dict) -> List[Tuple[str, torch.Tensor, bool]]:
    """(name, tensor, decays) of every leaf: one a layer for stacked leaves
    (``q.3`` is layer 3's query projection), the others whole."""
    L = dims(cfg)["L"]
    out = []
    for name, shape, _, _ in leaf_specs(cfg):
        decays = len(shape) >= 2
        if shape[0] == L and name not in ("embed", "lm_head", "final_norm"):
            out += [(f"{name}.{l}", w[name][l], decays) for l in range(L)]
        else:
            out.append((name, w[name], decays))
    return out


def loss_and_grads(w: Dict[str, torch.Tensor], cfg: Dict, tokens: torch.Tensor,
                   labels: torch.Tensor, prec: str = "fp32", row_block: int = 2048):
    """(loss, {leaf name: float32 gradient}) of the weights ``w`` (kept in
    their stored types) on one batch ``tokens, labels [B, S]``."""
    m = dims(cfg)
    names = [n for n, _, _ in leaves(w, cfg)]
    live = {n: t.detach().float().requires_grad_(True) for n, t, _ in leaves(w, cfg)}
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)
    x = live["embed"][tokens.long()]

    def run_layer(x, *flat, keys):
        return ref.layer(x, dict(zip(keys, flat)), m, pos, prec)

    for l in range(m["L"]):
        keys = [k for k in ref._LAYER_LEAVES if f"{k}.{l}" in live]
        x = ckpt.checkpoint(run_layer, x, *[live[f"{k}.{l}"] for k in keys], keys=keys,
                            use_reentrant=False, preserve_rng_state=False)
    head = live["lm_head"] if "lm_head" in live else live["embed"].T
    hs = x.reshape(B * S, -1)
    ys = labels.reshape(B * S)

    def block_loss(h, head, y):
        return ref.xent_sum(ref.rmsnorm(h, live["final_norm"], m["eps"]), head, y, prec)

    total = None
    for a in range(0, B * S, row_block):
        part = ckpt.checkpoint(block_loss, hs[a:a + row_block], head, ys[a:a + row_block],
                               use_reentrant=False, preserve_rng_state=False)
        total = part if total is None else total + part
    loss = total / (B * S)
    grads = torch.autograd.grad(loss, [live[n] for n in names])
    return loss.detach(), dict(zip(names, grads))


class AdamW:
    """The reference optimizer over ``leaves``: int8 moments per leaf."""

    def __init__(self, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, block=128):
        self.b1, self.b2, self.eps, self.wd, self.block = b1, b2, eps, weight_decay, block
        self.t = 0
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}

    @torch.no_grad()
    def step(self, named_leaves, grads: Dict[str, torch.Tensor], lr: torch.Tensor) -> None:
        """One update of every leaf in place; each leaf's gradient is
        dropped from ``grads`` once it is used.  Big leaves go in blocks of
        whole trailing-axis rows: every operation is elementwise or
        blockwise along that axis, so the blocks give the same values."""
        self.t += 1
        t = torch.tensor(float(self.t))
        c1 = 1.0 - torch.pow(torch.tensor(self.b1), t)
        c2 = 1.0 - torch.pow(torch.tensor(self.b2), t)
        for name, p, decays in named_leaves:
            g = grads.pop(name)
            n = p.shape[-1] if p.dim() else 1
            rows = p.numel() // n
            p2, g2 = p.view(rows, n), g.reshape(rows, n)
            st = self.state.get(name)
            if st is None:
                nb = -(-n // self.block)
                st = self.state[name] = {
                    "mq": torch.zeros((rows, n), dtype=torch.int8, device=p.device),
                    "ms": torch.zeros((rows, nb), dtype=torch.float32, device=p.device),
                    "vq": torch.zeros((rows, n), dtype=torch.int8, device=p.device),
                    "vs": torch.zeros((rows, nb), dtype=torch.float32, device=p.device)}
            c1d, c2d, lrd = c1.to(p.device), c2.to(p.device), lr.to(p.device)
            step = max(1, (1 << 24) // n)
            for lo in range(0, rows, step):
                sl = slice(lo, lo + step)
                gb = g2[sl].float()
                m = self.b1 * dequantize(st["mq"][sl], st["ms"][sl], "m", self.block) \
                    + (1.0 - self.b1) * gb
                v = self.b2 * dequantize(st["vq"][sl], st["vs"][sl], "v", self.block) \
                    + (1.0 - self.b2) * gb * gb
                upd = (m / c1d) / (torch.sqrt(v / c2d) + self.eps)
                p32 = p2[sl].float()
                if decays and self.wd:
                    upd = upd + self.wd * p32
                p2[sl].copy_(p32 - lrd * upd)
                for key, x, kind in (("m", m, "m"), ("v", v, "v")):
                    q, s = quantize(x, kind, self.block)
                    st[key + "q"][sl].copy_(q)
                    st[key + "s"][sl].copy_(s)
            del g

    def grad_norms_from_state(self) -> Dict[str, float]:
        """Each leaf's first gradient as the state holds it after one step:
        ‖dequant(m)‖ / (1 - b1)."""
        return {n: float(dequantize(s["mq"], s["ms"], "m", self.block).norm()) / (1.0 - self.b1)
                for n, s in self.state.items()}


def train_steps(w: Dict[str, torch.Tensor], cfg: Dict, batches, base_lr: float,
                warmup: int, remake, prec: str = "fp32") -> Dict:
    """The reference's first ``len(batches)`` steps from ``w`` (updated in
    place).  Returns the losses, each leaf's first gradient norm from the
    optimizer's state after step 1, and each leaf's change after the last
    step against the starting weights ``remake()`` gives again, all float."""
    named = leaves(w, cfg)
    opt = AdamW()
    losses, first = [], None
    for i, (tokens, labels) in enumerate(batches):
        loss, grads = loss_and_grads(w, cfg, tokens, labels, prec)
        losses.append(float(loss))
        opt.step(named, grads, lr_at(i, base_lr, warmup))
        del grads
        if i == 0:
            first = opt.grad_norms_from_state()
    del opt
    start = dict((n, t) for n, t, _ in leaves(remake(), cfg))
    change = {n: float((t.float() - start[n].float()).norm()) for n, t, _ in named}
    return {"losses": losses, "grad_norms": first, "change_norms": change}
