"""nemotron-4-15b — 32L d_model=6144 48H (GQA kv=8) d_ff=24576, squared-ReLU.

[arXiv:2402.16819]  vocab 256000, no gated MLP (relu² activation), RoPE GQA.
"""
from repro_torch.configs.base import AttnConfig, BlockConfig, ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    d_model=6_144,
    vocab=256_000,
    blocks=(
        BlockConfig(
            kind="dense",
            n_layers=32,
            attn=AttnConfig(kind="gqa", n_heads=48, n_kv_heads=8, d_head=128),
            d_ff=24_576,
            activation="relu2",
        ),
    ),
    remat="full",
)

SMOKE = ModelConfig(
    name="nemotron-4-smoke",
    d_model=64,
    vocab=256,
    blocks=(
        BlockConfig(
            kind="dense",
            n_layers=2,
            attn=AttnConfig(kind="gqa", n_heads=4, n_kv_heads=2, d_head=16),
            d_ff=128,
            activation="relu2",
        ),
    ),
)
