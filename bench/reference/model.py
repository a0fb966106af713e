"""The plain reference forward: a decoder of dense GQA or top-k MoE layers.

Float32 throughout (the caller turns TF32 off), no cache, no batching
across requests, no kernel: RMSNorm, rotary embeddings (rotate-half over
the whole head), causal grouped-query attention computed in blocks of
query rows, SwiGLU, and for MoE a float32 softmax router whose top-k
experts (ties to the lower index) are weighted by their renormalised
probabilities, every routed token computed (no capacity, no drop).

``prec="fp8"`` is the control: every projection (attention, MLP,
experts, head) takes both operands through float8 e4m3, the activations
scaled per row and the weights per output column, and multiplies the
rounded values in float32.  The router, the norms and the attention
scores stay float32.

The weights are ``reference.weights`` tensors; a layer's leaves are cast
to float32 where they are used, so only one layer is ever held in float32.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

__all__ = ["rmsnorm", "rope", "attend", "mm", "moe", "layer", "logits_at", "xent_sum",
           "no_tf32"]

_E4M3_MAX = 448.0


class no_tf32:
    """Float32 products in full float32 on the card while inside."""

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self._saved
        return False


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the gradient passes straight through the rounding)."""
    with torch.no_grad():
        scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / _E4M3_MAX
        low = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (low - x).detach() if x.requires_grad else low


def mm(x: torch.Tensor, w: torch.Tensor, prec: str = "fp32") -> torch.Tensor:
    """``x [.., n] @ w [n, m]`` in float32, or through float8 (``prec="fp8"``)."""
    x, w = x.float(), w.float()
    if prec == "fp8":
        x, w = _fp8(x, -1), _fp8(w, -2)
    return x @ w


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, H, D] float32, pos [S] → rotated (rotate-half)."""
    D = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D))
    ang = pos.float()[:, None] * freqs
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attend(q, k, v, q_block: int = 1024):
    """Causal attention of positions 0..S-1: q [B, S, H, D], k/v [B, S, Hkv, D]."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(D)
    outs = []
    for a in range(0, S, q_block):
        b = min(S, a + q_block)
        qb = q[:, a:b].reshape(B, b - a, Hkv, G, D)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qb, k[:, :b]) * scale
        qi = torch.arange(a, b, device=q.device)[:, None]
        kj = torch.arange(b, device=q.device)[None, :]
        s = s.masked_fill(kj > qi, float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, v[:, :b])
        outs.append(o.reshape(B, b - a, H, D))
    return torch.cat(outs, dim=1)


def moe(h: torch.Tensor, router, wg, wu, wd, top_k: int, prec: str = "fp32"):
    """h [T, d]; ``wg/wu [E, d, F]``, ``wd [E, F, d]`` → [T, d]."""
    probs = torch.softmax(h @ router.float(), dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :top_k]
    gates = torch.gather(probs, -1, top)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    out = torch.zeros_like(h)
    for e in torch.unique(top).tolist():
        rows, slot = (top == e).nonzero(as_tuple=True)
        he = h[rows]
        y = mm(F.silu(mm(he, wg[e], prec)) * mm(he, wu[e], prec), wd[e], prec)
        out = out.index_add(0, rows, y * gates[rows, slot, None])
    return out


def layer(x: torch.Tensor, p: Dict[str, torch.Tensor], m: Dict, pos: torch.Tensor,
          prec: str = "fp32", q_block: int = 1024) -> torch.Tensor:
    """One decoder layer on x [B, S, d] float32 (``p``: this layer's leaves)."""
    B, S, d = x.shape
    H, Hkv, D = m["H"], m["Hkv"], m["D"]
    h = rmsnorm(x, p["ln1"], m["eps"])
    q = rope(mm(h, p["q"], prec).reshape(B, S, H, D), pos, m["theta"])
    k = rope(mm(h, p["k"], prec).reshape(B, S, Hkv, D), pos, m["theta"])
    v = mm(h, p["v"], prec).reshape(B, S, Hkv, D)
    x = x + mm(attend(q, k, v, q_block).reshape(B, S, H * D), p["o"], prec)
    h = rmsnorm(x, p["ln2"], m["eps"])
    if m["moe"]:
        y = moe(h.reshape(B * S, d), p["router"], p["w_gate"], p["w_up"], p["w_down"],
                m["top_k"], prec).reshape(B, S, d)
    else:
        y = mm(F.silu(mm(h, p["w_gate"], prec)) * mm(h, p["w_up"], prec), p["w_down"], prec)
    return x + y


_LAYER_LEAVES = ("ln1", "ln2", "q", "k", "v", "o", "router", "w_gate", "w_up", "w_down")


def layer_params(w: Dict[str, torch.Tensor], l: int) -> Dict[str, torch.Tensor]:
    return {n: w[n][l] for n in _LAYER_LEAVES if n in w}


def head_of(w: Dict[str, torch.Tensor]) -> torch.Tensor:
    return w["lm_head"] if "lm_head" in w else w["embed"].T


@torch.no_grad()
def logits_at(w: Dict[str, torch.Tensor], m: Dict, tokens: torch.Tensor,
              rows: torch.Tensor, prec: str = "fp32", q_block: int = 1024) -> torch.Tensor:
    """Float32 logits [len(rows), V] of one sequence ``tokens [S]`` at the
    positions ``rows`` (each row's logits predict the token after it)."""
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    x = w["embed"][tokens.long()].float()[None]
    for l in range(m["L"]):
        x = layer(x, layer_params(w, l), m, pos, prec, q_block)
    h = rmsnorm(x[0, rows.long()], w["final_norm"], m["eps"])
    return mm(h, head_of(w), prec)


def xent_sum(h: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
             prec: str = "fp32") -> torch.Tensor:
    """Σ over rows of logsumexp(logits) - logits[label], float32."""
    logits = mm(h, head, prec)
    return (torch.logsumexp(logits, dim=-1)
            - torch.gather(logits, -1, labels.long()[:, None])[:, 0]).sum()


def served_gaps(w, m, prompt: torch.Tensor, served: torch.Tensor,
                control: Optional[str] = None, q_block: int = 1024) -> Dict[str, List[float]]:
    """Per served token, how far its float32 reference logit lies below the
    reference's best at that position (``program``); with ``control`` set
    to a precision, the same gap for the token that precision's forward
    puts first there (``control``)."""
    seq = torch.cat([prompt.long(), served.long()[:-1]])
    rows = torch.arange(prompt.shape[0] - 1, seq.shape[0], device=seq.device)
    ref = logits_at(w, m, seq, rows, "fp32", q_block)
    best = ref.max(dim=-1).values
    out = {"program": (best - ref.gather(-1, served.long()[:, None])[:, 0]).tolist()}
    if control is not None:
        low = logits_at(w, m, seq, rows, control, q_block)
        pick = low.argmax(dim=-1)
        out["control"] = (best - ref.gather(-1, pick[:, None])[:, 0]).tolist()
    return out
