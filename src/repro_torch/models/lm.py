"""Decoder LM over stacked layer segments (dense, MoE, Hymba and xLSTM
stacks, GQA or MLA attention), with MusicGen's K codebooks (tokens
``[B, K, S]``: the K embeddings of a frame summed, K heads) and Qwen2-VL's
vision stub (precomputed patch embeddings over the leading positions, and
M-RoPE's (t, h, w) position ids).

Params for each segment are stacked ``[n_layers, ...]`` as in the JAX
package; a Python loop over the layers takes the place of its ``lax.scan``.
Each segment's leaves are split into their per-layer slices by one
``unbind`` a leaf, so that the backward stacks each leaf's gradient once
(indexing ``a[layer]`` would send a zero-padded ``[L, ...]`` gradient back
from every layer).  When autograd records, ``cfg.remat`` rematerialises
each layer as the reference's ``jax.checkpoint`` does: ``full`` keeps only
the layer's inputs, ``dots`` also keeps its matmul outputs.  ``loss_fn`` is
the training loss, with DeepSeek's multi-token-prediction (``mtp``) term;
serving never reads the ``mtp`` subtree.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.utils.checkpoint as torch_checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.odin_linear import OdinConfig
from repro_torch.nn.attention import POOL_LEAVES
from repro_torch.nn.blocks import block_apply, block_cache, block_spec
from repro_torch.nn.layers import embed, embed_spec, linear, norm_spec, rmsnorm
from repro_torch.nn.module import ParamSpec, count_params
from repro_torch.nn.pcontext import active, collective_scope, constrain, is_dtensor
from repro_torch.tree import leaves_with_path, tree_map

__all__ = ["param_spec", "forward", "init_caches", "kv_dtype", "loss_fn", "model_flops"]

_KV_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
              "float16": torch.float16, "int8": torch.int8}


def kv_dtype(cfg: ModelConfig) -> torch.dtype:
    """The decode caches' element type (``cfg.kv_dtype``)."""
    return _KV_DTYPES[cfg.kv_dtype]


def _stack(tree, n: int):
    return tree_map(
        lambda s: ParamSpec((n, *s.shape), ("layers", *s.logical_axes), s.dtype,
                            s.init, s.scale), tree)


def _odin(cfg: ModelConfig) -> Optional[OdinConfig]:
    return None if cfg.odin_mode == "exact" else OdinConfig(mode=cfg.odin_mode)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def param_spec(cfg: ModelConfig) -> Dict:
    K = cfg.n_codebooks
    spec: Dict = {
        "embed": embed_spec(cfg.vocab, cfg.d_model) if K == 1
        else ParamSpec((K, cfg.vocab, cfg.d_model), (None, "vocab", "embed")),
        "final_norm": norm_spec(cfg.d_model),
        "segments": [_stack(block_spec(b, cfg.d_model), b.n_layers) for b in cfg.blocks],
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = (
            ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab"), init="fan_in")
            if K == 1 else
            ParamSpec((K, cfg.d_model, cfg.vocab), (None, "embed", "vocab"), init="fan_in"))
    if cfg.mtp:
        spec["mtp"] = {
            "proj": ParamSpec((2 * cfg.d_model, cfg.d_model), ("embed", "embed2"),
                              init="fan_in"),
            "norm": norm_spec(cfg.d_model),
            "block": block_spec(cfg.blocks[0], cfg.d_model),
        }
    return spec


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _restack(stacked, per_layer, name: str = ""):
    """New stacked cache from per-layer caches: pool leaves were written in
    place through per-layer views and are returned as they are; the other
    leaves (``pos``) are stacked anew."""
    if isinstance(stacked, dict):
        return {k: _restack(v, [pl[k] for pl in per_layer], k)
                for k, v in stacked.items()}
    if name in POOL_LEAVES:
        return stacked
    return torch.stack(per_layer)


# matmuls with no batch dimension: the products that ``remat="dots"``
# saves, as ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` does
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (torch_checkpoint.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


def _rematerialised(layer, remat: str):
    """``layer`` under ``cfg.remat``: ``none`` as it is, ``full`` under
    ``torch.utils.checkpoint`` (only its inputs saved), ``dots`` under
    selective checkpointing that also saves the matmul outputs."""
    if remat == "none":
        return layer
    # the forward draws no random numbers: no RNG state to stash and restore
    if remat == "full":
        return functools.partial(torch_checkpoint.checkpoint, layer, use_reentrant=False,
                                 preserve_rng_state=False)
    if remat == "dots":
        contexts = functools.partial(torch_checkpoint.create_selective_checkpoint_contexts,
                                     _save_dots)
        return functools.partial(torch_checkpoint.checkpoint, layer, use_reentrant=False,
                                 preserve_rng_state=False, context_fn=contexts)
    raise ValueError(f"unknown remat {remat!r}")


def _records(seg, x) -> bool:
    """Whether autograd records a segment's forward."""
    return torch.is_grad_enabled() and (
        x.requires_grad or any(a.requires_grad for _, _, a in leaves_with_path(seg)))


class _Slices:
    """A leaf's per-layer slices (a tree leaf, not a tree node)."""
    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = parts


def _layer_slices(seg, n: int):
    """The per-layer slices of a stacked segment: one ``unbind`` a leaf."""
    cols = tree_map(lambda a: _Slices(a.unbind(0)), seg)
    return [tree_map(lambda c: c.parts[i], cols) for i in range(n)]


def forward(params, tokens, cfg: ModelConfig, caches=None, patch_embeds=None,
            pos3d=None, start_pos=None, moe_no_drop: bool = False, tables=None,
            spec_decode: bool = False, q_lens=None, q_decode=None):
    """tokens: [B,S] (or [B,K,S] multi-codebook) → (logits [B,S,V] (or
    [B,S,K,V]), new_caches, hidden).

    ``caches``: list of per-segment stacked caches (or None).
    ``patch_embeds [B, P, d]`` (vision stub) replace the embeddings of
    positions ``0..P-1``; ``pos3d [B, S, 3]`` are the M-RoPE position ids of
    the S tokens.  ``start_pos``:
    absolute position of tokens[:, 0] (a scalar or per-slot [B, 1] tensor);
    defaults to 0.  ``moe_no_drop``: route MoE blocks without capacity
    dropping (the serving paths: exact, per-token routing).  ``tables``:
    per-slot KV block tables [B, n_pages] of the paged pool (one table
    serves every layer).  ``spec_decode``, ``q_lens``
    and ``q_decode`` are passed to the paged attention core (see
    ``nn.attention._paged_gqa_core``); with ``q_lens`` the ``start_pos`` is
    the per-slot position of row 0 of the right-aligned tile.
    """
    odin = _odin(cfg)
    if cfg.n_codebooks > 1:
        # MusicGen: the K codebook embeddings of a frame, stacked [B, K, S, d]
        # and summed in one reduction (the reference's order of rounding)
        K = cfg.n_codebooks
        per = torch.stack([embed(tokens[:, k], params["embed"][k]) for k in range(K)],
                          dim=1)
        x = per.sum(dim=1)
    else:
        x = embed(tokens, params["embed"])
    if cfg.vision_stub and patch_embeds is not None:
        # the patch rows overlay the image-token positions, out of place
        n = patch_embeds.shape[1]
        if n > x.shape[1]:
            raise ValueError(f"{n} patch embeddings overlay only {x.shape[1]} tokens")
        x = torch.cat([patch_embeds.to(x.dtype), x[:, n:]], dim=1)
    # the carry's layout from the start (the identity outside a
    # logical_sharding context)
    x = constrain(x, ("batch", "act_seq", None))
    B, S = x.shape[0], x.shape[1]
    start = 0 if start_pos is None else start_pos
    positions = (start + torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
                 + torch.zeros((B, 1), dtype=torch.int32, device=x.device))

    new_caches = []
    for i, bcfg in enumerate(cfg.blocks):
        seg = params["segments"][i]
        c = caches[i] if caches is not None else None
        per_layer = []

        def layer(p_l, x, c_l, bcfg=bcfg):
            if active():
                # pin each per-layer param slice to its logical sharding, as
                # the reference pins its scan's slices
                with collective_scope("weights"):
                    p_l = tree_map(lambda w, s: constrain(w, s.logical_axes), p_l,
                                   block_spec(bcfg, cfg.d_model))
            y, c2 = block_apply(p_l, x, bcfg, cache=c_l, positions=positions,
                                odin=odin, norm_eps=cfg.norm_eps,
                                moe_no_drop=moe_no_drop, tables=tables,
                                spec_decode=spec_decode, q_lens=q_lens,
                                q_decode=q_decode, pos3d=pos3d)
            # pin the activation carry (the identity outside a
            # logical_sharding context)
            return constrain(y, ("batch", "act_seq", None)), c2

        if _records(seg, x):
            layer = _rematerialised(layer, cfg.remat)
        for l, p_l in enumerate(_layer_slices(seg, bcfg.n_layers)):
            c_l = None if c is None else tree_map(lambda a: a[l], c)
            x, c2 = layer(p_l, x, c_l)
            per_layer.append(c2)
        new_caches.append(None if c is None else _restack(c, per_layer))

    hidden = x
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if cfg.n_codebooks > 1 and is_dtensor(x):
        # a DTensor einsum folds the codebook axis into a sharded one
        logits = torch.stack([linear(x, head[k]) for k in range(cfg.n_codebooks)], dim=2)
    elif cfg.n_codebooks > 1:
        logits = torch.einsum("bsd,kdv->bskv", x, head.to(x.dtype))
    else:
        logits = linear(x, head)
    return logits, (new_caches if caches is not None else None), hidden


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                attn_override=None, device=None):
    """Stacked per-segment decode caches (``dtype`` defaults to the config's
    ``kv_dtype``): dense, ring-buffer or MLA latent attention caches with a
    scalar ``pos``, a Hymba segment's SSM state, and an xLSTM segment's cell
    state (float32 whatever ``dtype`` says).  ``attn_override(block_cfg)``
    returns a segment's attention cache instead (the serving layer passes
    the paged block pool) or None to keep the dense one; an overridden
    dense cache is never built."""
    if dtype is None:
        dtype = kv_dtype(cfg)
    out = []
    for b in cfg.blocks:
        sub = attn_override(b) if attn_override is not None else None
        one = block_cache(b, cfg.d_model, batch, max_len, dtype, device, attn=sub)
        out.append(tree_map(lambda a: a.expand(b.n_layers, *a.shape).clone(), one))
    return out


def _xent(logits, labels, vocab: int):
    """Per-token cross-entropy in float32: ``logsumexp - logit[label]``, the
    max subtracted first and held out of the gradient.  The label's logit
    is picked by ``gather`` (the reference's masked sum adds one nonzero
    term to zeros, so the value is the same) and no ``[..., V]`` mask is
    built."""
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True).detach()
    shifted = logits - m
    lse = torch.log(torch.exp(shifted).sum(dim=-1))
    if is_dtensor(shifted):
        # the per-token loss laid out as the labels are: DTensor may leave
        # the difference sharded over the vocabulary's mesh dims too
        return (lse - _masked_pick(shifted, labels)).redistribute(
            shifted.device_mesh, labels.placements)
    picked = torch.gather(shifted, -1, labels[..., None].long())[..., 0]
    return lse - picked


def _masked_pick(shifted, labels):
    """The label's entry of a DTensor ``shifted [..., V]`` by the
    reference's masked sum, against a vocabulary index sharded as
    ``shifted``'s last axis is: every op stays vocab-local and the sum over
    the vocabulary is a partial sum (a gather would collect the whole
    vocabulary axis on every rank)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    last = shifted.ndim - 1
    iota = distribute_tensor(
        torch.arange(shifted.shape[-1], dtype=torch.int32, device=shifted.device),
        shifted.device_mesh,
        [Shard(0) if isinstance(p, Shard) and p.dim == last else Replicate()
         for p in shifted.placements], src_data_rank=None)
    return torch.where(iota == labels[..., None], shifted, 0.0).sum(dim=-1)


def loss_fn(params, batch: Dict, cfg: ModelConfig):
    """Training loss of a batch: tokens ``[B, S]`` (``[B, K, S]``), labels of
    the same shape, and the vision stub's ``patch_embeds`` and ``pos3d``
    where the batch has them.  Returns (loss, metrics).  MoE blocks route
    with capped capacity (dropping), as the reference's training does.
    DeepSeek's MTP head predicts token t+2 from h_t and the embedding of
    t+1 through one more block of the first segment's kind; its loss enters
    at weight 0.1."""
    tokens, labels = batch["tokens"], batch["labels"]
    logits, _, h = forward(params, tokens, cfg, patch_embeds=batch.get("patch_embeds"),
                           pos3d=batch.get("pos3d"))
    if cfg.n_codebooks > 1:
        loss = _xent(logits, labels.transpose(1, 2), cfg.vocab).mean()
    else:
        loss = _xent(logits, labels, cfg.vocab).mean()
    metrics = {"loss": loss}
    if cfg.mtp:
        x = embed(tokens, params["embed"])
        hm = rmsnorm(h[:, :-1], params["mtp"]["norm"], cfg.norm_eps)
        comb = torch.cat([hm, x[:, 1:]], dim=-1)
        z = torch.matmul(comb, params["mtp"]["proj"].to(comb.dtype))
        B, S1 = z.shape[0], z.shape[1]
        pos = (torch.arange(S1, dtype=torch.int32, device=z.device)[None, :]
               + torch.zeros((B, 1), dtype=torch.int32, device=z.device))
        z, _ = block_apply(params["mtp"]["block"], z, cfg.blocks[0], positions=pos,
                           odin=_odin(cfg), norm_eps=cfg.norm_eps)
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        mtp_logits = torch.matmul(z, head.to(z.dtype))[:, :-1]         # predicts t+2
        mtp_loss = _xent(mtp_logits, labels[:, 2:], cfg.vocab).mean()
        metrics["mtp_loss"] = mtp_loss
        loss = loss + 0.1 * mtp_loss
    metrics["loss_total"] = loss
    return loss, metrics


def model_flops(cfg: ModelConfig, n_tokens: int, train: bool = True) -> float:
    """MODEL_FLOPS = 6·N_active·D for training, 2·N_active·D for inference:
    the parameters a token touches, every one but the routed experts it does
    not pick (``n_experts - top_k`` of them in each MoE layer)."""
    inactive = 0
    for b in cfg.blocks:
        if b.kind == "moe" and b.moe is not None:
            per_expert = 3 * cfg.d_model * b.moe.d_ff
            inactive += b.n_layers * per_expert * (b.moe.n_experts - b.moe.top_k)
    mult = 6.0 if train else 2.0
    return mult * (count_params(param_spec(cfg)) - inactive) * n_tokens
