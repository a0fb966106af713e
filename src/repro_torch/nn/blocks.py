"""Transformer blocks: the dense, MoE and Hymba branches of the JAX
package's ``nn/blocks.py``.  Dense and MoE blocks are attention (GQA or
MLA) + MLP or mixture of experts; a Hymba block runs attention and a
selective SSM in parallel on the same input and fuses them through
per-branch output norms and a learned per-channel mix.  xLSTM blocks are
not ported yet.
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

__all__ = ["block_spec", "block_apply", "block_cache"]


def _check_kind(cfg: BlockConfig) -> None:
    if cfg.kind not in ("dense", "moe", "hymba"):
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
    built."""
    _check_kind(cfg)
    if attn is None:
        attn = init_cache(cfg.attn, batch, max_len, dtype, device)
    if cfg.kind == "hymba":
        return {"attn": attn,
                "ssm": init_ssm_state(cfg.ssm, d_model, batch, device=device)}
    return {"attn": attn}


def block_apply(p, x, cfg: BlockConfig, cache=None, positions=None, odin=None,
                norm_eps: float = 1e-5, moe_no_drop: bool = False, tables=None,
                spec_decode: bool = False, q_lens=None, q_decode=None):
    """(params, x [B,S,d], cache) → (x', cache').  ``moe_no_drop`` routes an
    MoE block without capacity dropping; ``tables``, ``spec_decode``,
    ``q_lens`` and ``q_decode`` go to the paged attention core (``q_lens``,
    the mixed tile, for dense and MoE blocks only)."""
    _check_kind(cfg)
    if q_lens is not None and cfg.kind == "hymba":
        raise ValueError("mixed dispatch (q_lens) supports paged GQA blocks only")
    if cfg.kind == "hymba":
        h = rmsnorm(x, p["ln1"], norm_eps)
        a, ac = attention(p["attn"], h, cfg.attn, positions=positions,
                          cache=None if cache is None else cache["attn"], odin=odin,
                          tables=tables)
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
