"""phi3-medium-14b — 40L d_model=5120 40H (GQA kv=10) d_ff=17920, RoPE SwiGLU.

[arXiv:2404.14219]  vocab 100352.
"""
from repro_torch.configs.base import AttnConfig, BlockConfig, ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    d_model=5_120,
    vocab=100_352,
    blocks=(
        BlockConfig(
            kind="dense",
            n_layers=40,
            attn=AttnConfig(kind="gqa", n_heads=40, n_kv_heads=10, d_head=128),
            d_ff=17_920,
            activation="swiglu",
        ),
    ),
    remat="full",
)

SMOKE = ModelConfig(
    name="phi3-medium-smoke",
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
