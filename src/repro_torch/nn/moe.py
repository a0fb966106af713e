"""Mixture-of-Experts: top-k router + capacity-based scatter dispatch.

The JAX package's ``nn/moe.py`` in PyTorch, with the same semantics: the
sort-based static-shape dispatch (rank each (token, k) assignment within its
expert by a stable sort, drop overflow beyond ``capacity`` to an
out-of-bounds sentinel, gather token rows into a dense ``[E, C, d]``
buffer), one grouped product per expert weight over all ``E`` experts
(``torch.bmm``), and the gate-weighted combine.  No ``[T, E, C]`` one-hot
tensor is built.

Router: softmax over float32 logits (``x.float() @ router``, the router a
float32 leaf; a float32 product on the card runs in full float32 unless the
caller turns TF32 on), top-k by a stable descending sort so that equal
scores pick the lower expert index first, as ``jax.lax.top_k`` does.
DeepSeek-style extensions: shared (always-on) experts, the only part that
goes through ODIN's ``linear``, and the aux-loss-free bias, added to the
routing scores for *selection* only, never to the gate weight.

The reference's sharding hints (``constrain``) are no-ops outside a
sharding context and are left out.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core.odin_linear import OdinConfig
from repro_torch.nn.layers import linear, linear_spec
from repro_torch.nn.module import ParamSpec

__all__ = ["moe_spec", "moe_block", "dispatch_indices", "top_k_lowest_first"]


def moe_spec(cfg: MoEConfig, d_model: int) -> Dict[str, ParamSpec]:
    E, Fd = cfg.n_experts, cfg.d_ff
    spec = {
        "router": ParamSpec((d_model, E), ("embed", None), torch.float32, init="fan_in"),
        "w_gate": ParamSpec((E, d_model, Fd), ("experts", "embed", "mlp"), init="fan_in"),
        "w_up": ParamSpec((E, d_model, Fd), ("experts", "embed", "mlp"), init="fan_in"),
        "w_down": ParamSpec((E, Fd, d_model), ("experts", "mlp", "embed"), init="fan_in"),
    }
    if cfg.aux_free_bias:
        spec["route_bias"] = ParamSpec((E,), (None,), torch.float32, init="zeros")
    if cfg.n_shared:
        S = cfg.n_shared * cfg.d_ff
        spec["shared_gate"] = linear_spec(d_model, S, ("embed", "mlp"))
        spec["shared_up"] = linear_spec(d_model, S, ("embed", "mlp"))
        spec["shared_down"] = linear_spec(S, d_model, ("mlp", "embed"))
    return spec


def top_k_lowest_first(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest scores along the last axis, largest
    first, equal scores in ascending index order (``jax.lax.top_k``'s
    order).  ``torch.topk`` promises no order among ties; a stable
    descending sort keeps equal elements in their input order."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]


def dispatch_indices(expert_ids: torch.Tensor, n_experts: int, capacity: int):
    """Rank each (token·k) assignment within its expert; static shapes.

    expert_ids: int32 [A].  Returns (slot [A] int32, keep [A] bool) where
    ``slot = expert·C + rank`` for kept assignments (rank < capacity) and
    the out-of-bounds sentinel ``E·C`` for dropped ones — a scatter by slot
    must target ``E·C + 1`` entries and drop the last (a 0 sentinel, or a
    clamp, would clobber expert 0's first slot).
    """
    A = expert_ids.shape[0]
    dev = expert_ids.device
    order = torch.argsort(expert_ids, stable=True)            # assignments grouped by expert
    sorted_ids = expert_ids[order]
    # rank within group = index - start index of that expert's run
    starts = torch.searchsorted(sorted_ids,
                                torch.arange(n_experts, dtype=expert_ids.dtype, device=dev),
                                side="left", out_int32=True)
    rank_sorted = torch.arange(A, dtype=torch.int32, device=dev) - starts[sorted_ids.long()]
    rank = torch.zeros((A,), dtype=torch.int32, device=dev)
    rank[order] = rank_sorted
    keep = rank < capacity
    sentinel = torch.full_like(rank, n_experts * capacity)
    slot = torch.where(keep, expert_ids.to(torch.int32) * capacity + rank, sentinel)
    return slot, keep


def _expert_ffn(buf, p, activation_kind: str, dtype):
    """Every expert's FFN over its capacity rows: [E, C, d] → [E, C, d]."""
    g = torch.bmm(buf, p["w_gate"].to(dtype))
    u = torch.bmm(buf, p["w_up"].to(dtype))
    if activation_kind == "swiglu":
        h = F.silu(g) * u
    elif activation_kind == "relu2":
        r = F.relu(g)
        h = r * r * u
    else:
        h = F.gelu(g, approximate="tanh") * u                 # jax.nn.gelu's default
    return torch.bmm(h, p["w_down"].to(dtype))


def moe_block(p, x: torch.Tensor, cfg: MoEConfig, activation_kind: str = "swiglu",
              no_drop: bool = False, odin: Optional[OdinConfig] = None) -> torch.Tensor:
    """x: [B, S, d] → [B, S, d]."""
    B, S, d = x.shape
    T = B * S
    k, E = cfg.top_k, cfg.n_experts
    dev = x.device
    xt = x.reshape(T, d)

    logits = xt.float() @ p["router"]                           # [T, E] float32
    probs = torch.softmax(logits, dim=-1)
    select_scores = probs + p["route_bias"][None, :] if "route_bias" in p else probs
    top_idx = top_k_lowest_first(select_scores, k)              # [T, k]
    gates = torch.gather(probs, 1, top_idx)                     # gate from *unbiased* probs
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    A = T * k
    expert_ids = top_idx.reshape(A).to(torch.int32)
    if no_drop or S == 1:
        # Inference-exact routing (the reference's reasoning): a dropped
        # assignment couples a token's output to what else shares the batch,
        # and makes chunked prefill route differently from one pass.  Decode
        # (S == 1) is always drop-free; serving prefill sets ``no_drop``.
        capacity = T
    else:
        capacity = max(1, int(T * k * cfg.capacity_factor / E))
    slot, keep = dispatch_indices(expert_ids, E, capacity)

    token_idx = torch.arange(T, dtype=torch.int32, device=dev).repeat_interleave(k)
    assign = torch.arange(A, dtype=torch.int32, device=dev)
    # Dispatch in gather form: scatter scalar assignment ids into the slot
    # table (one entry past the end takes the dropped ones' sentinel writes,
    # all of value A), then gather token rows.
    slot_to_assign = torch.full((E * capacity + 1,), A, dtype=torch.int32, device=dev)
    slot_to_assign[slot.long()] = torch.where(keep, assign, A)
    slot_to_assign = slot_to_assign[:E * capacity]
    token_for_slot = torch.cat([token_idx, token_idx.new_zeros(1)])[slot_to_assign.long()]
    filled = (slot_to_assign < A)[:, None]
    buf = torch.where(filled, xt[token_for_slot.long()], 0).reshape(E, capacity, d)

    y = _expert_ffn(buf, p, activation_kind, x.dtype).reshape(E * capacity, d)

    # combine: gather each assignment's expert output (a dropped one's
    # sentinel reads a clamped row and is zeroed, as the reference's
    # out-of-bounds gather is), weight by its gate, and sum each token's k
    # contiguous assignments in assignment order, rounding to x.dtype after
    # each add — the reference's segment_sum over token_idx, with no
    # atomics, so the sum is the same run to run and at any batch.
    rows = y[slot.clamp_max(E * capacity - 1).long()]
    out_per_assign = torch.where(keep[:, None], rows, 0)       # [A, d]
    weighted = (out_per_assign * gates.reshape(A, 1).to(x.dtype)).reshape(T, k, d)
    out = weighted[:, 0]
    for j in range(1, k):
        out = out + weighted[:, j]

    if "shared_gate" in p:
        sg = F.silu(linear(xt, p["shared_gate"], odin)) * linear(xt, p["shared_up"], odin)
        out = out + linear(sg, p["shared_down"], odin)
    return out.reshape(B, S, d)
