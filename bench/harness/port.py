"""The program under test, as the benchmark sees it: ``repro_torch``'s
configuration, parameter tree and entry points, built from a
configuration file and the benchmark's own weights.

This is the one harness module that imports the program.  It imports
nothing of the JAX package.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import AttnConfig, BlockConfig, ModelConfig, MoEConfig
from repro_torch.models import lm, registry
from reference.weights import dims

__all__ = ["model_config", "param_tree", "flat_leaves"]


def model_config(cfg: Dict, remat: str = "none") -> ModelConfig:
    """The port's ``ModelConfig``, built from a configuration file.  Where
    the file names the port's registry id (``port_arch``), the result must
    equal that registered model at the file's depth, norm epsilon, RoPE
    base and head tying: the benchmark runs the model the port registers,
    with the published settings the port takes as options."""
    m = dims(cfg)
    attn = AttnConfig(kind="gqa", n_heads=m["H"], n_kv_heads=m["Hkv"], d_head=m["D"],
                      rope_theta=m["theta"])
    if m["moe"]:
        block = BlockConfig(kind="moe", n_layers=m["L"], attn=attn,
                            moe=MoEConfig(n_experts=m["E"], top_k=m["top_k"], d_ff=m["F"],
                                          n_shared=0, capacity_factor=1.25,
                                          aux_free_bias=False))
    else:
        block = BlockConfig(kind="dense", n_layers=m["L"], attn=attn, d_ff=m["F"],
                            activation="swiglu")
    name = cfg.get("port_arch", cfg.get("name", "bench-model"))
    out = ModelConfig(name=name, d_model=m["d"], vocab=m["V"], blocks=(block,),
                      norm_eps=m["eps"], tie_embeddings=m["tied"], remat=remat)
    if "port_arch" in cfg:
        reg = registry.get_config(cfg["port_arch"])
        b0 = reg.blocks[0]
        want = reg.with_overrides(
            norm_eps=m["eps"], remat=remat, tie_embeddings=m["tied"],
            blocks=(BlockConfig(kind=b0.kind, n_layers=m["L"],
                                attn=AttnConfig(**{**b0.attn.__dict__, "rope_theta": m["theta"]}),
                                moe=b0.moe, d_ff=b0.d_ff, activation=b0.activation),))
        if want != out:
            raise ValueError(f"{cfg['port_arch']}: the configuration file does not describe "
                             f"the registered model:\n{want}\n!=\n{out}")
    return out


def param_tree(w: Dict[str, torch.Tensor], mcfg: ModelConfig) -> Dict:
    """The port's parameter tree over the benchmark's weights (the same
    tensors, no copy), checked leaf by leaf against ``lm.param_spec``."""
    b = mcfg.blocks[0]
    seg = {"ln1": w["ln1"], "ln2": w["ln2"],
           "attn": {n: w[n] for n in ("q", "k", "v", "o")}}
    if b.kind == "moe":
        seg["moe"] = {n: w[n] for n in ("router", "w_gate", "w_up", "w_down")}
    else:
        seg["mlp"] = {n: w[n] for n in ("w_gate", "w_up", "w_down")}
    tree = {"embed": w["embed"], "final_norm": w["final_norm"], "segments": [seg]}
    if not mcfg.tie_embeddings:
        tree["lm_head"] = w["lm_head"]
    _check(tree, lm.param_spec(mcfg), "params")
    return tree


def _check(tree, spec, path: str) -> None:
    if isinstance(spec, dict):
        if not isinstance(tree, dict) or set(tree) != set(spec):
            raise ValueError(f"{path}: keys {sorted(tree)} != {sorted(spec)}")
        for k in spec:
            _check(tree[k], spec[k], f"{path}.{k}")
    elif isinstance(spec, list):
        for i, (t, s) in enumerate(zip(tree, spec, strict=True)):
            _check(t, s, f"{path}[{i}]")
    elif tuple(tree.shape) != tuple(spec.shape) or tree.dtype != spec.dtype:
        raise ValueError(f"{path}: {tuple(tree.shape)} {tree.dtype} != "
                         f"{tuple(spec.shape)} {spec.dtype}")


def flat_leaves(tree: Dict) -> Dict:
    """The inverse of ``param_tree`` on any tree of that shape (the
    optimizer's moments too): leaf name → subtree."""
    seg = tree["segments"][0]
    out = {"embed": tree["embed"], "final_norm": tree["final_norm"],
           "ln1": seg["ln1"], "ln2": seg["ln2"], **seg["attn"]}
    out.update(seg["moe"] if "moe" in seg else seg["mlp"])
    if "lm_head" in tree:
        out["lm_head"] = tree["lm_head"]
    return out
