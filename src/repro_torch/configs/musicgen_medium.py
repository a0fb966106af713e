"""musicgen-medium — 48L d_model=1536 24H (MHA kv=24) d_ff=6144, vocab 2048.

[arXiv:2306.05284; hf]  Decoder-only transformer over EnCodec tokens, 4
codebooks with the delay interleaving pattern handled by the data layer.  The
EnCodec frontend is a STUB (assignment): ``input_specs()`` provides the 4
parallel codebook token streams; the model sums 4 codebook embeddings per
frame and predicts 4 codebook heads (models/lm.py ``n_codebooks=4``).
"""
from repro_torch.configs.base import AttnConfig, BlockConfig, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    d_model=1_536,
    vocab=2_048,
    blocks=(
        BlockConfig(
            kind="dense",
            n_layers=48,
            attn=AttnConfig(kind="gqa", n_heads=24, n_kv_heads=24, d_head=64),
            d_ff=6_144,
            activation="gelu",
        ),
    ),
    n_codebooks=4,
    remat="full",
)

SMOKE = ModelConfig(
    name="musicgen-smoke",
    d_model=64,
    vocab=64,
    blocks=(
        BlockConfig(
            kind="dense",
            n_layers=2,
            attn=AttnConfig(kind="gqa", n_heads=4, n_kv_heads=4, d_head=16),
            d_ff=128,
            activation="gelu",
        ),
    ),
    n_codebooks=4,
)
