"""Model/run configuration schema.

One :class:`ModelConfig` describes any architecture in the assigned pool:
dense/MoE transformers (GQA or MLA attention), SSM hybrids (Hymba), xLSTM
stacks, multi-codebook audio LMs (MusicGen), and VLM backbones (Qwen2-VL).
The layer stack is a *pattern* of segments so heterogeneous stacks (DeepSeek's
dense-then-MoE, xLSTM's mLSTM/sLSTM alternation) still scan (DESIGN.md §3).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

__all__ = ["AttnConfig", "MoEConfig", "SSMConfig", "BlockConfig", "ModelConfig", "ShapeConfig", "LM_SHAPES"]


@dataclass(frozen=True)
class AttnConfig:
    kind: str = "gqa"             # gqa | mla
    n_heads: int = 8
    n_kv_heads: int = 8
    d_head: int = 64
    rope: str = "rope"            # rope | mrope | none
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = (16, 24, 24)   # t/h/w splits of d_head/2
    window: int = 0               # >0 ⇒ sliding-window attention
    # MLA (DeepSeek-V3) dims
    q_lora_rank: int = 0
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_ff: int = 1024              # per-expert hidden
    n_shared: int = 0             # shared (always-on) experts
    capacity_factor: float = 1.25
    aux_free_bias: bool = True    # DeepSeek-V3 aux-loss-free load balancing
    router_dtype: str = "float32"


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    expand: int = 2
    conv_dim: int = 4
    dt_rank: int = 0              # 0 ⇒ ceil(d_model/16)


@dataclass(frozen=True)
class BlockConfig:
    """One layer-stack segment: ``n_layers`` identical blocks, scanned."""

    kind: str                     # dense | moe | hymba | mlstm | slstm
    n_layers: int
    attn: Optional[AttnConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    d_ff: int = 0                 # dense-MLP hidden (0 ⇒ no MLP, e.g. xLSTM)
    activation: str = "swiglu"    # swiglu | relu2 | gelu
    mlstm_impl: str = "chunkwise" # chunkwise (prod) | scan (reference/baseline)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    vocab: int
    blocks: Tuple[BlockConfig, ...]
    norm: str = "rmsnorm"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    n_codebooks: int = 1          # >1 ⇒ MusicGen-style multi-codebook LM
    vision_stub: bool = False     # Qwen2-VL: frontend provides patch embeds
    mtp: bool = False             # DeepSeek multi-token-prediction head
    logical_rules: Dict[str, object] = field(default_factory=dict)
    # ODIN integration: execution mode for Linear layers (paper's technique)
    odin_mode: str = "exact"      # exact | int8 | sc
    # decode-cache element type: "int8" stores KV (or MLA latents) as 8-bit
    # fixed-point — ODIN's fixed-8-bit-operand adjustment applied to the
    # decode working set (halves cache capacity AND per-token HBM traffic,
    # §Perf-3); "bfloat16" is the exact baseline.
    kv_dtype: str = "bfloat16"
    remat: str = "none"           # none | full | dots
    dtype: str = "bfloat16"

    @property
    def n_layers(self) -> int:
        return sum(b.n_layers for b in self.blocks)

    def with_overrides(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


LM_SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
