"""Blocks: the dense, MoE, Hymba and xLSTM branches of the JAX package's
``nn/blocks.py``.  Dense and MoE blocks are attention (GQA or MLA) + MLP or
mixture of experts; a Hymba block runs attention and a selective SSM in
parallel on the same input and fuses them through per-branch output norms
and a learned per-channel mix; an mLSTM or sLSTM block is a pre-norm
recurrent cell with a residual, and holds no attention cache.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import BlockConfig
from repro_torch.nn.attention import attention, attn_spec, init_cache
from repro_torch.nn.layers import activation, linear, linear_spec, norm_spec, rmsnorm
from repro_torch.nn.module import ParamSpec
from repro_torch.nn.moe import moe_block, moe_spec
from repro_torch.nn.ssm import init_ssm_state, ssm_block, ssm_spec
from repro_torch.nn.xlstm import (init_mlstm_state, init_slstm_state, mlstm_block,
                                  mlstm_spec, slstm_block, slstm_spec)

__all__ = ["block_spec", "block_apply", "block_cache"]


def _check_kind(cfg: BlockConfig) -> None:
    if cfg.kind not in ("dense", "moe", "hymba", "mlstm", "slstm"):
        raise ValueError(f"unknown block kind {cfg.kind!r}")


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
    if cfg.kind == "mlstm":
        return {"ln1": norm_spec(d_model), "cell": mlstm_spec(cfg.attn.n_heads, d_model)}
    if cfg.kind == "slstm":
        return {"ln1": norm_spec(d_model), "cell": slstm_spec(cfg.attn.n_heads, d_model)}
    spec = {
        "ln1": norm_spec(d_model),
        "ln2": norm_spec(d_model),
        "attn": attn_spec(cfg.attn, d_model),
    }
    if cfg.kind == "dense":
        spec["mlp"] = _mlp_spec(d_model, cfg.d_ff, cfg.activation)
    elif cfg.kind == "moe":
        spec["moe"] = moe_spec(cfg.moe, d_model)
    else:
        spec.update(
            ssm=ssm_spec(cfg.ssm, d_model),
            attn_out_norm=norm_spec(d_model),
            ssm_out_norm=norm_spec(d_model),
            mix_beta=ParamSpec((2, d_model), (None, "embed"), torch.float32, init="ones"),
            mlp=_mlp_spec(d_model, cfg.d_ff, cfg.activation))
    return spec


def block_cache(cfg: BlockConfig, d_model: int, batch: int, max_len: int,
                dtype=torch.bfloat16, device=None, attn=None):
    """Per-layer decode state for one block.  ``attn`` replaces the dense
    attention cache (the serving layer's paged pool), which is then never
    built.  xLSTM blocks hold their cell's float32 state alone, whatever
    ``dtype`` says, and ignore ``attn``."""
    _check_kind(cfg)
    if cfg.kind == "mlstm":
        return {"cell": init_mlstm_state(cfg.attn.n_heads, d_model, batch, device)}
    if cfg.kind == "slstm":
        return {"cell": init_slstm_state(d_model, batch, device)}
    if attn is None:
        attn = init_cache(cfg.attn, batch, max_len, dtype, device)
    if cfg.kind == "hymba":
        return {"attn": attn,
                "ssm": init_ssm_state(cfg.ssm, d_model, batch, device=device)}
    return {"attn": attn}


def block_apply(p, x, cfg: BlockConfig, cache=None, positions=None, odin=None,
                norm_eps: float = 1e-5, moe_no_drop: bool = False, tables=None,
                spec_decode: bool = False, q_lens=None, q_decode=None, pos3d=None):
    """(params, x [B,S,d], cache) → (x', cache').  ``moe_no_drop`` routes an
    MoE block without capacity dropping; ``tables``, ``spec_decode``,
    ``q_lens`` and ``q_decode`` go to the paged attention core (``q_lens``,
    the mixed tile, for dense and MoE blocks only); ``pos3d`` to an M-RoPE
    attention layer."""
    _check_kind(cfg)
    if q_lens is not None and cfg.kind not in ("dense", "moe"):
        raise ValueError("mixed dispatch (q_lens) supports paged GQA blocks only")
    if cfg.kind in ("mlstm", "slstm"):
        h = rmsnorm(x, p["ln1"], norm_eps)
        st = None if cache is None else cache["cell"]
        if cfg.kind == "mlstm":
            y, st = mlstm_block(p["cell"], h, cfg.attn.n_heads, state=st, odin=odin,
                                impl=cfg.mlstm_impl)
        else:
            y, st = slstm_block(p["cell"], h, state=st, odin=odin)
        return x + y, None if cache is None else {**cache, "cell": st}
    if cfg.kind == "hymba":
        h = rmsnorm(x, p["ln1"], norm_eps)
        a, ac = attention(p["attn"], h, cfg.attn, positions=positions,
                          cache=None if cache is None else cache["attn"], odin=odin,
                          tables=tables, pos3d=pos3d)
        s, sc = ssm_block(p["ssm"], h, cfg.ssm,
                          state=None if cache is None else cache["ssm"], odin=odin)
        # Hymba fusion: per-branch output norm, learnable per-channel mix
        fused = 0.5 * (
            p["mix_beta"][0] * rmsnorm(a, p["attn_out_norm"], norm_eps).float()
            + p["mix_beta"][1] * rmsnorm(s, p["ssm_out_norm"], norm_eps).float())
        x = x + fused.to(x.dtype)
        x = x + _mlp(p["mlp"], rmsnorm(x, p["ln2"], norm_eps), cfg.activation, odin)
        new_cache = None if cache is None else {**cache, "attn": ac, "ssm": sc}
        return x, new_cache
    a, ac = attention(p["attn"], rmsnorm(x, p["ln1"], norm_eps), cfg.attn,
                      positions=positions,
                      cache=None if cache is None else cache["attn"], odin=odin,
                      tables=tables, spec_decode=spec_decode, q_lens=q_lens,
                      q_decode=q_decode, pos3d=pos3d)
    x = x + a
    h = rmsnorm(x, p["ln2"], norm_eps)
    if cfg.kind == "dense":
        x = x + _mlp(p["mlp"], h, cfg.activation, odin)
    else:
        x = x + moe_block(p["moe"], h, cfg.moe, cfg.activation, no_drop=moe_no_drop,
                          odin=odin)
    new_cache = None if cache is None else {**cache, "attn": ac}
    return x, new_cache
