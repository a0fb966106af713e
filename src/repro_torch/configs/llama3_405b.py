"""llama3-405b — 126L d_model=16384 128H (GQA kv=8) d_ff=53248, vocab 128256.

[arXiv:2407.21783]  The FSDP + int8-optimizer memory path exists for this
arch (DESIGN.md §4): 405B bf16 params shard over the full mesh.
"""
from repro_torch.configs.base import AttnConfig, BlockConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    d_model=16_384,
    vocab=128_256,
    blocks=(
        BlockConfig(
            kind="dense",
            n_layers=126,
            attn=AttnConfig(kind="gqa", n_heads=128, n_kv_heads=8, d_head=128),
            d_ff=53_248,
            activation="swiglu",
        ),
    ),
    remat="full",
)

SMOKE = ModelConfig(
    name="llama3-smoke",
    d_model=64,
    vocab=256,
    blocks=(
        BlockConfig(
            kind="dense",
            n_layers=2,
            attn=AttnConfig(kind="gqa", n_heads=4, n_kv_heads=2, d_head=16),
            d_ff=128,
        ),
    ),
)
