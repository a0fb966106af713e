"""qwen2-vl-2b — 28L d_model=1536 12H (GQA kv=2) d_ff=8960, M-RoPE, vocab 151936.

[arXiv:2409.12191; hf]  VLM backbone only (assignment): the dynamic-resolution
vision frontend is a STUB — ``input_specs()`` supplies precomputed patch
embeddings which overlay the leading token positions (models/lm.py), plus the
3-D (t, h, w) M-RoPE position ids.  d_head = 1536/12 = 128.
"""
from repro_torch.configs.base import AttnConfig, BlockConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    d_model=1_536,
    vocab=151_936,
    blocks=(
        BlockConfig(
            kind="dense",
            n_layers=28,
            attn=AttnConfig(
                kind="gqa", n_heads=12, n_kv_heads=2, d_head=128,
                rope="mrope", mrope_sections=(16, 24, 24),
            ),
            d_ff=8_960,
            activation="swiglu",
        ),
    ),
    vision_stub=True,
    remat="full",
)

SMOKE = ModelConfig(
    name="qwen2-vl-smoke",
    d_model=64,
    vocab=256,
    blocks=(
        BlockConfig(
            kind="dense",
            n_layers=2,
            attn=AttnConfig(
                kind="gqa", n_heads=4, n_kv_heads=2, d_head=16,
                rope="mrope", mrope_sections=(2, 3, 3),
            ),
            d_ff=128,
        ),
    ),
    vision_stub=True,
)
