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

On DTensor tokens the block runs ``_moe_sharded``: the reference's global
dispatch order (every rank ranks all the replicated expert ids), each rank
filling and running its own block of the dispatch buffer, placed as the
reference's sharding hint places it (experts × capacity).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core.odin_linear import OdinConfig
from repro_torch.nn.layers import linear, linear_spec
from repro_torch.nn.module import ParamSpec
from repro_torch.nn.pcontext import (active, collective_scope, from_block, is_dtensor,
                                     rule_placements, to_block)

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


def _capacity(T: int, S: int, cfg: MoEConfig, no_drop: bool) -> int:
    if no_drop or S == 1:
        # Inference-exact routing (the reference's reasoning): a dropped
        # assignment couples a token's output to what else shares the batch,
        # and makes chunked prefill route differently from one pass.  Decode
        # (S == 1) is always drop-free; serving prefill sets ``no_drop``.
        return T
    return max(1, int(T * cfg.top_k * cfg.capacity_factor / cfg.n_experts))


def _router(p, x, k: int):
    """(top-k expert ids, normalised gates) of every token of ``x [..., d]``:
    a float32 softmax, the selection on the biased scores, the gates from
    the unbiased ones."""
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    select_scores = probs + p["route_bias"] if "route_bias" in p else probs
    top_idx = top_k_lowest_first(select_scores, k)
    gates = torch.gather(probs, -1, top_idx)                    # gate from *unbiased* probs
    return top_idx, gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)


def _moe_sharded(p, x, cfg: MoEConfig, activation_kind: str, no_drop: bool, odin):
    """``moe_block`` on a DTensor ``x``, in the reference's global order: the
    router runs on the sharded tokens; the expert ids and gates of every
    token are replicated (int32 and float32 ``[T, k]``) and every rank runs
    the sort-based dispatch on all of them, so each drops exactly the
    assignments one device drops.  The tokens are gathered whole and each
    rank fills its own block of the ``[E, C, d]`` buffer, placed as the
    reference constrains it (experts × capacity); the experts' products
    run on that buffer, and each rank combines the assignments its block
    holds, in assignment order, into a partial sum over the ranks of every
    token's output (a reduce-scatter back to ``x``'s placements)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = x.device_mesh
    B, S, d = x.shape
    T, k, E = B * S, cfg.top_k, cfg.n_experts
    A = T * k
    dev = x.to_local().device
    whole = (Replicate(),) * mesh.ndim
    capacity = _capacity(T, S, cfg, no_drop)
    shape = (E, capacity, d)
    buf_pl = (rule_placements(shape, ("experts", "capacity", None)) if active()
              else whole)
    # the ranks that split the buffer hold partial sums of each token's
    # output (and of the gradients of the tokens and gates they read)
    partial = tuple(Partial() if isinstance(q, Shard) else Replicate() for q in buf_pl)
    # the router on each rank's own tokens (its weights gathered whole), the
    # ids and gates then gathered whole
    tok_pl = tuple(q if isinstance(q, Shard) and q.dim < 2 else Replicate()
                   for q in x.placements)
    with collective_scope("weights"):
        router = {name: to_block(p[name], mesh, whole, tok_pl)
                  for name in ("router", "route_bias") if name in p}
    top_idx, gates = _router(router, to_block(x, mesh, tok_pl), k)
    with collective_scope("moe dispatch"):
        expert_ids = from_block(top_idx, mesh, tok_pl, (B, S, k)).redistribute(
            mesh, whole).to_local().reshape(A).to(torch.int32)
        gates = from_block(gates, mesh, tok_pl, (B, S, k)).redistribute(mesh, whole).to_local(
            grad_placements=partial).reshape(T, k)
        xt = x.redistribute(mesh, whole).to_local(grad_placements=partial).reshape(T, d)
    slot, keep = dispatch_indices(expert_ids, E, capacity)

    local, off = compute_local_shape_and_global_offset(shape, mesh, buf_pl)
    (e0, c0), (El, Cl) = off[:2], local[:2]
    token_idx = torch.arange(T, dtype=torch.int32, device=dev).repeat_interleave(k)
    slot_to_assign = torch.full((E * capacity + 1,), A, dtype=torch.int32, device=dev)
    slot_to_assign[slot.long()] = torch.where(
        keep, torch.arange(A, dtype=torch.int32, device=dev), A)
    mine = slot_to_assign[:E * capacity].reshape(E, capacity)[e0:e0 + El, c0:c0 + Cl]
    mine = mine.reshape(-1)
    token_for_slot = torch.cat([token_idx, token_idx.new_zeros(1)])[mine.long()]
    buf = torch.where((mine < A)[:, None], xt[token_for_slot.long()], 0)

    # this rank's experts, whole; their gradients are partial sums over the
    # ranks that split the capacity
    w_pl = tuple(q if isinstance(q, Shard) and q.dim == 0 else Replicate() for q in buf_pl)
    w_grad = tuple(q if isinstance(q, Shard) and q.dim == 0 else r
                   for q, r in zip(buf_pl, partial))
    with collective_scope("weights"):
        w = {name: (p[name].redistribute(mesh, w_pl).to_local(grad_placements=w_grad)
                    if is_dtensor(p[name]) else p[name][e0:e0 + El])
             for name in ("w_gate", "w_up", "w_down")}
    y = _expert_ffn(buf.reshape(El, Cl, d), w, activation_kind, x.dtype).reshape(El * Cl, d)

    # the combine: each token's k assignments in assignment order, those
    # outside this rank's block (or dropped) adding exact zeros
    e, c = torch.div(slot, capacity, rounding_mode="floor"), slot % capacity
    held = keep & (e >= e0) & (e < e0 + El) & (c >= c0) & (c < c0 + Cl)
    at = torch.where(held, (e - e0) * Cl + (c - c0), 0).reshape(T, k).long()
    held = held.reshape(T, k)
    out = None
    for j in range(k):
        wj = torch.where(held[:, j, None], y[at[:, j]], 0) * gates[:, j, None].to(x.dtype)
        out = wj if out is None else out + wj
    with collective_scope("moe dispatch"):
        out = from_block(out.reshape(B, S, d), mesh, partial, (B, S, d)).redistribute(
            mesh, tok_pl)
    if "shared_gate" in p:
        sg = F.silu(linear(x, p["shared_gate"], odin)) * linear(x, p["shared_up"], odin)
        out = out + linear(sg, p["shared_down"], odin)
    return out


def moe_block(p, x: torch.Tensor, cfg: MoEConfig, activation_kind: str = "swiglu",
              no_drop: bool = False, odin: Optional[OdinConfig] = None) -> torch.Tensor:
    """x: [B, S, d] → [B, S, d].  A DTensor ``x`` takes ``_moe_sharded``."""
    if is_dtensor(x):
        return _moe_sharded(p, x, cfg, activation_kind, no_drop, odin)
    B, S, d = x.shape
    T = B * S
    k, E = cfg.top_k, cfg.n_experts
    dev = x.device
    xt = x.reshape(T, d)
    top_idx, gates = _router(p, xt, k)                          # [T, k] each

    A = T * k
    expert_ids = top_idx.reshape(A).to(torch.int32)
    capacity = _capacity(T, S, cfg, no_drop)
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
    # the reference's sharding hints (experts × capacity) act in
    # ``_moe_sharded``: a DTensor ``x`` never reaches this path
    buf = torch.where(filled, xt[token_for_slot.long()], 0).reshape(E, capacity, d)

    y = _expert_ffn(buf, p, activation_kind, x.dtype).reshape(E * capacity, d)

    # combine: gather each assignment's expert output (a dropped one's
    # sentinel reads a clamped row and is zeroed, as the reference's
    # out-of-bounds gather is), weight by its gate, and sum each token's k
    # contiguous assignments in assignment order, rounding to x.dtype after
    # each add — the reference's segment_sum over token_idx, with no
    # atomics, so the sum is the same run to run and at any batch.
    rows = y[slot.clamp_max(E * capacity - 1).long()]
    out_per_assign = torch.where(keep[:, None], rows, 0)
    weighted = (out_per_assign * gates.reshape(A, 1).to(x.dtype)).reshape(T, k, d)
    out = weighted[:, 0]
    for j in range(1, k):
        out = out + weighted[:, j]

    if "shared_gate" in p:
        sg = F.silu(linear(xt, p["shared_gate"], odin)) * linear(xt, p["shared_up"], odin)
        out = out + linear(sg, p["shared_down"], odin)
    return out.reshape(B, S, d)
