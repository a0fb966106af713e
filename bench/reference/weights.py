"""Seeded random weights of a configuration, made on the device.

The benchmark makes the weights itself and hands the same tensors to the
program and to the reference.  Every bfloat16 leaf is a view of one flat
buffer filled by a few large ``normal_`` draws from one ``torch.Generator``
on the device, then scaled in place; the float32 leaves (norm gains, the
router) come from a second flat buffer.  The same seed on the same device
gives the same weights, so the reference can make them again after the
program's state is freed.

Layout (``L`` layers stacked on the leading axis, ``x @ w`` for every
projection):

  embed [V, d], lm_head [d, V] (absent when tied), final_norm [d];
  ln1, ln2 [L, d]; q [L, d, H*D], k, v [L, d, Hkv*D], o [L, H*D, d];
  dense: w_gate, w_up [L, d, F], w_down [L, F, d];
  moe:   router [L, d, E] (float32), w_gate, w_up [L, E, d, Fe],
         w_down [L, E, Fe, d].

Initialisation: embedding N(0, 0.02^2), projections N(0, 1/fan_in) with
the fan-in of one layer's (one expert's) matrix, norm gains 1.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

__all__ = ["dims", "leaf_specs", "make_weights", "param_count"]

# elements of one draw: bounded so that a draw's offset stays well inside
# what one generator call addresses
_DRAW = 1 << 28


def dims(cfg: Dict) -> Dict[str, int]:
    """The widths of a configuration file (Hugging Face key names).  A file
    that states a rotary fraction, a RoPE scaling or a q/k norm, none of
    which the reference computes, is refused."""
    if (float(cfg.get("partial_rotary_factor") or 1.0) != 1.0 or cfg.get("rope_scaling")
            or cfg.get("qk_norm")):
        raise ValueError(f"{cfg.get('name')}: partial rotary, RoPE scaling and q/k norm "
                         "are not in the reference")
    d = int(cfg["hidden_size"])
    H = int(cfg["num_attention_heads"])
    out = {
        "d": d, "V": int(cfg["vocab_size"]), "L": int(cfg["num_hidden_layers"]),
        "H": H, "Hkv": int(cfg["num_key_value_heads"]),
        "D": int(cfg.get("head_dim") or d // H),
        "tied": bool(cfg.get("tie_word_embeddings", False)),
        "eps": float(cfg["rms_norm_eps"]), "theta": float(cfg["rope_theta"]),
    }
    if cfg.get("num_experts"):
        out.update(E=int(cfg["num_experts"]), top_k=int(cfg["num_experts_per_tok"]),
                   F=int(cfg["moe_intermediate_size"]), moe=True)
    else:
        out.update(F=int(cfg["intermediate_size"]), moe=False)
    return out


def leaf_specs(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], torch.dtype, str]]:
    """(name, shape, dtype, init) of every leaf, in drawing order."""
    m = dims(cfg)
    d, V, L, H, Hkv, D, F = m["d"], m["V"], m["L"], m["H"], m["Hkv"], m["D"], m["F"]
    bf, f32 = torch.bfloat16, torch.float32
    out = [("embed", (V, d), bf, "embed")]
    if not m["tied"]:
        out.append(("lm_head", (d, V), bf, "fan_in"))
    out += [("final_norm", (d,), f32, "ones"), ("ln1", (L, d), f32, "ones"),
            ("ln2", (L, d), f32, "ones"),
            ("q", (L, d, H * D), bf, "fan_in"), ("k", (L, d, Hkv * D), bf, "fan_in"),
            ("v", (L, d, Hkv * D), bf, "fan_in"), ("o", (L, H * D, d), bf, "fan_in")]
    if m["moe"]:
        E = m["E"]
        out += [("router", (L, d, E), f32, "fan_in"),
                ("w_gate", (L, E, d, F), bf, "fan_in"), ("w_up", (L, E, d, F), bf, "fan_in"),
                ("w_down", (L, E, F, d), bf, "fan_in")]
    else:
        out += [("w_gate", (L, d, F), bf, "fan_in"), ("w_up", (L, d, F), bf, "fan_in"),
                ("w_down", (L, F, d), bf, "fan_in")]
    return out


def param_count(cfg: Dict) -> int:
    return sum(math.prod(shape) for _, shape, _, _ in leaf_specs(cfg))


def _fill(flat: torch.Tensor, gen: torch.Generator) -> None:
    for lo in range(0, flat.numel(), _DRAW):
        flat[lo:lo + _DRAW].normal_(generator=gen)


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's weights for ``seed`` on ``device``."""
    specs = leaf_specs(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    out: Dict[str, torch.Tensor] = {}
    for dtype in (torch.bfloat16, torch.float32):
        mine = [s for s in specs if s[2] == dtype]
        total = sum(math.prod(shape) for _, shape, _, _ in mine)
        flat = torch.empty(total, dtype=dtype, device=device)
        drawn = [s for s in mine if s[3] != "ones"]
        n_drawn = sum(math.prod(shape) for _, shape, _, _ in drawn)
        # drawn leaves first, so one contiguous stretch takes the draws
        lo = 0
        for name, shape, _, init in drawn + [s for s in mine if s[3] == "ones"]:
            n = math.prod(shape)
            out[name] = flat[lo:lo + n].view(shape)
            lo += n
        _fill(flat[:n_drawn], gen)
        flat[n_drawn:].fill_(1.0)
        for name, shape, _, init in drawn:
            std = 0.02 if init == "embed" else 1.0 / math.sqrt(shape[-2])
            out[name].mul_(std)
    return out
