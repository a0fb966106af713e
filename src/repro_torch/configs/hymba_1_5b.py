"""hymba-1.5b — 32L d_model=1600 25H (GQA kv=5) d_ff=5504, parallel attn+mamba.

[arXiv:2411.13676; hf]  Hybrid-head blocks: attention and a selective SSM run
in parallel on the same input, fused via per-branch output norms and learned
per-channel mixing (nn/blocks.py "hymba").  Sliding-window attention
(window=1024) everywhere except three global-attention layers (first, middle,
last) — the SWA + O(1) SSM state makes this a sub-quadratic arch, so it RUNS
the long_500k cell.  ssm_state=16, d_head = 1600/25 = 64.
"""
from repro_torch.configs.base import AttnConfig, BlockConfig, ModelConfig, SSMConfig

_SSM = SSMConfig(state_dim=16, expand=2, conv_dim=4)


def _attn(window: int) -> AttnConfig:
    return AttnConfig(kind="gqa", n_heads=25, n_kv_heads=5, d_head=64, window=window)


CONFIG = ModelConfig(
    name="hymba-1.5b",
    d_model=1_600,
    vocab=32_001,
    blocks=(
        BlockConfig(kind="hymba", n_layers=1, attn=_attn(0), ssm=_SSM, d_ff=5_504),
        BlockConfig(kind="hymba", n_layers=14, attn=_attn(1_024), ssm=_SSM, d_ff=5_504),
        BlockConfig(kind="hymba", n_layers=1, attn=_attn(0), ssm=_SSM, d_ff=5_504),
        BlockConfig(kind="hymba", n_layers=15, attn=_attn(1_024), ssm=_SSM, d_ff=5_504),
        BlockConfig(kind="hymba", n_layers=1, attn=_attn(0), ssm=_SSM, d_ff=5_504),
    ),
    remat="full",
)

_SMOKE_SSM = SSMConfig(state_dim=4, expand=2, conv_dim=4)

SMOKE = ModelConfig(
    name="hymba-smoke",
    d_model=64,
    vocab=256,
    blocks=(
        BlockConfig(
            kind="hymba", n_layers=2,
            attn=AttnConfig(kind="gqa", n_heads=4, n_kv_heads=2, d_head=16, window=8),
            ssm=_SMOKE_SSM, d_ff=128,
        ),
        BlockConfig(
            kind="hymba", n_layers=1,
            attn=AttnConfig(kind="gqa", n_heads=4, n_kv_heads=2, d_head=16),
            ssm=_SMOKE_SSM, d_ff=128,
        ),
    ),
)
