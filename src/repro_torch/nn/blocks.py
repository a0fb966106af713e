"""Transformer blocks: the dense and MoE branches (attention + MLP or
mixture of experts) of the JAX package's ``nn/blocks.py``.  Hymba and xLSTM
blocks are not ported yet.
"""
from __future__ import annotations

from typing import Dict

import torch.nn.functional as F

from repro_torch.configs.base import BlockConfig
from repro_torch.nn.attention import attention, attn_spec
from repro_torch.nn.layers import activation, linear, linear_spec, norm_spec, rmsnorm
from repro_torch.nn.module import ParamSpec
from repro_torch.nn.moe import moe_block, moe_spec

__all__ = ["block_spec", "block_apply"]


def _check_kind(cfg: BlockConfig) -> None:
    if cfg.kind not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.kind} blocks are not ported to PyTorch yet (see ROADMAP.md)")


def _mlp_spec(d_model: int, d_ff: int, act: str) -> Dict[str, ParamSpec]:
    if act == "swiglu":
        return {
            "w_gate": linear_spec(d_model, d_ff, ("embed", "mlp")),
            "w_up": linear_spec(d_model, d_ff, ("embed", "mlp")),
            "w_down": linear_spec(d_ff, d_model, ("mlp", "embed")),
        }
    return {
        "w_up": linear_spec(d_model, d_ff, ("embed", "mlp")),
        "w_down": linear_spec(d_ff, d_model, ("mlp", "embed")),
    }


def _mlp(p, x, act: str, odin):
    if act == "swiglu":
        h = F.silu(linear(x, p["w_gate"], odin)) * linear(x, p["w_up"], odin)
    else:
        h = activation(linear(x, p["w_up"], odin), act)
    return linear(h, p["w_down"], odin)


def block_spec(cfg: BlockConfig, d_model: int) -> Dict:
    _check_kind(cfg)
    spec = {
        "ln1": norm_spec(d_model),
        "ln2": norm_spec(d_model),
        "attn": attn_spec(cfg.attn, d_model),
    }
    if cfg.kind == "dense":
        spec["mlp"] = _mlp_spec(d_model, cfg.d_ff, cfg.activation)
    else:
        spec["moe"] = moe_spec(cfg.moe, d_model)
    return spec


def block_apply(p, x, cfg: BlockConfig, cache=None, positions=None, odin=None,
                norm_eps: float = 1e-5, moe_no_drop: bool = False, tables=None,
                spec_decode: bool = False, q_lens=None, q_decode=None):
    """(params, x [B,S,d], cache) → (x', cache').  ``moe_no_drop`` routes an
    MoE block without capacity dropping; ``tables``, ``spec_decode``,
    ``q_lens`` and ``q_decode`` go to the paged attention core."""
    _check_kind(cfg)
    a, ac = attention(p["attn"], rmsnorm(x, p["ln1"], norm_eps), cfg.attn,
                      positions=positions,
                      cache=None if cache is None else cache["attn"], odin=odin,
                      tables=tables, spec_decode=spec_decode, q_lens=q_lens,
                      q_decode=q_decode)
    x = x + a
    h = rmsnorm(x, p["ln2"], norm_eps)
    if cfg.kind == "dense":
        x = x + _mlp(p["mlp"], h, cfg.activation, odin)
    else:
        x = x + moe_block(p["moe"], h, cfg.moe, cfg.activation, no_drop=moe_no_drop,
                          odin=odin)
    new_cache = None if cache is None else {**cache, "attn": ac}
    return x, new_cache
