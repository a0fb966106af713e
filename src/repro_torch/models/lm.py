"""Decoder LM over stacked layer segments (dense and MoE GQA stacks).

Params for each segment are stacked ``[n_layers, ...]`` as in the JAX
package; a Python loop over the layers takes the place of its ``lax.scan``
(no rematerialisation: the port only runs inference).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.odin_linear import OdinConfig
from repro_torch.nn.attention import POOL_LEAVES
from repro_torch.nn.blocks import block_apply, block_spec
from repro_torch.nn.layers import embed, embed_spec, norm_spec, rmsnorm
from repro_torch.nn.module import ParamSpec, count_params
from repro_torch.tree import tree_map

__all__ = ["param_spec", "forward", "init_caches", "model_flops"]


def _stack(tree, n: int):
    return tree_map(
        lambda s: ParamSpec((n, *s.shape), ("layers", *s.logical_axes), s.dtype,
                            s.init, s.scale), tree)


def _odin(cfg: ModelConfig) -> Optional[OdinConfig]:
    return None if cfg.odin_mode == "exact" else OdinConfig(mode=cfg.odin_mode)


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.n_codebooks > 1 or cfg.vision_stub or cfg.mtp:
        raise NotImplementedError(
            f"{cfg.name}: multi-codebook, vision-stub and MTP models are not "
            "ported yet (see ROADMAP.md)")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def param_spec(cfg: ModelConfig) -> Dict:
    _check_supported(cfg)
    spec: Dict = {
        "embed": embed_spec(cfg.vocab, cfg.d_model),
        "final_norm": norm_spec(cfg.d_model),
        "segments": [_stack(block_spec(b, cfg.d_model), b.n_layers) for b in cfg.blocks],
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab"),
                                    init="fan_in")
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


def forward(params, tokens, cfg: ModelConfig, caches=None, start_pos=None,
            moe_no_drop: bool = False, tables=None, spec_decode: bool = False,
            q_lens=None, q_decode=None):
    """tokens: [B,S] → (logits [B,S,V], new_caches, hidden).

    ``caches``: list of per-segment stacked caches (or None).  ``start_pos``:
    absolute position of tokens[:, 0] (a scalar or per-slot [B, 1] tensor);
    defaults to 0.  ``moe_no_drop``: route MoE blocks without capacity
    dropping (the serving paths: exact, per-token routing).  ``tables``:
    per-slot KV block tables [B, n_pages] of the paged pool (one table
    serves every layer).  ``spec_decode``, ``q_lens``
    and ``q_decode`` are passed to the paged attention core (see
    ``nn.attention._paged_gqa_core``); with ``q_lens`` the ``start_pos`` is
    the per-slot position of row 0 of the right-aligned tile.
    """
    _check_supported(cfg)
    odin = _odin(cfg)
    x = embed(tokens, params["embed"])
    B, S = x.shape[0], x.shape[1]
    start = 0 if start_pos is None else start_pos
    positions = (start + torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
                 + torch.zeros((B, 1), dtype=torch.int32, device=x.device))

    new_caches = []
    for i, bcfg in enumerate(cfg.blocks):
        seg = params["segments"][i]
        c = caches[i] if caches is not None else None
        per_layer = []
        for layer in range(bcfg.n_layers):
            p_l = tree_map(lambda a: a[layer], seg)
            c_l = None if c is None else tree_map(lambda a: a[layer], c)
            x, c2 = block_apply(p_l, x, bcfg, cache=c_l, positions=positions,
                                odin=odin, norm_eps=cfg.norm_eps,
                                moe_no_drop=moe_no_drop, tables=tables,
                                spec_decode=spec_decode, q_lens=q_lens,
                                q_decode=q_decode)
            per_layer.append(c2)
        new_caches.append(None if c is None else _restack(c, per_layer))

    hidden = x
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = torch.matmul(x, head.to(x.dtype))
    return logits, (new_caches if caches is not None else None), hidden


def init_caches(cfg: ModelConfig, attn_override):
    """Stacked per-segment decode caches.  ``attn_override(block_cfg)``
    returns one layer's attention cache (the serving layer passes the paged
    block pool); the dense caches of the JAX package are not ported."""
    out = []
    for b in cfg.blocks:
        sub = attn_override(b)
        if sub is None:
            raise NotImplementedError(
                f"{b.kind} segment: only the paged KV pool is ported (see ROADMAP.md)")
        out.append(tree_map(lambda a: a.expand(b.n_layers, *a.shape).clone(),
                            {"attn": sub}))
    return out


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
