"""qwen3-moe-235b-a22b — 94L d_model=4096 64H (GQA kv=4), MoE 128e top-8.

[hf:Qwen/Qwen3-30B-A3B family; assignment dims]  d_ff=1536 per routed expert,
vocab 151936, no shared experts, RoPE GQA.
"""
from repro_torch.configs.base import AttnConfig, BlockConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    d_model=4_096,
    vocab=151_936,
    blocks=(
        BlockConfig(
            kind="moe",
            n_layers=94,
            attn=AttnConfig(kind="gqa", n_heads=64, n_kv_heads=4, d_head=128),
            moe=MoEConfig(
                n_experts=128, top_k=8, d_ff=1_536, n_shared=0,
                capacity_factor=1.25, aux_free_bias=False,
            ),
        ),
    ),
    remat="full",
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke",
    d_model=64,
    vocab=256,
    blocks=(
        BlockConfig(
            kind="moe",
            n_layers=2,
            attn=AttnConfig(kind="gqa", n_heads=4, n_kv_heads=2, d_head=16),
            moe=MoEConfig(n_experts=8, top_k=2, d_ff=32, aux_free_bias=False),
        ),
    ),
)
