"""phi4-mini-3.8b — 32L d_model=3072 24H (GQA kv=8) d_ff=8192, RoPE SwiGLU.

[arXiv:2412.08905; hf]  vocab 200064.
"""
from repro_torch.configs.base import AttnConfig, BlockConfig, ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    d_model=3_072,
    vocab=200_064,
    blocks=(
        BlockConfig(
            kind="dense",
            n_layers=32,
            attn=AttnConfig(kind="gqa", n_heads=24, n_kv_heads=8, d_head=128),
            d_ff=8_192,
            activation="swiglu",
        ),
    ),
    remat="full",
)

SMOKE = ModelConfig(
    name="phi4-mini-smoke",
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
