"""xlstm-350m — 24L d_model=1024, sLSTM + mLSTM blocks, vocab 50304, d_ff=0.

[arXiv:2405.04517]  xLSTM[7:1]-style stack: ratio 7 mLSTM (matrix memory,
parallel-friendly) to 1 sLSTM (scalar memory, strictly recurrent), repeated
three times.  4 heads.  O(1) recurrent state ⇒ RUNS the long_500k cell.
d_ff=0 per the assignment — the cells carry their own up/down projections,
there is no separate MLP.
"""
from repro_torch.configs.base import AttnConfig, BlockConfig, ModelConfig

_HEADS = AttnConfig(kind="gqa", n_heads=4, n_kv_heads=4, d_head=256)


def _seg(kind: str, n: int) -> BlockConfig:
    return BlockConfig(kind=kind, n_layers=n, attn=_HEADS, d_ff=0)


CONFIG = ModelConfig(
    name="xlstm-350m",
    d_model=1_024,
    vocab=50_304,
    blocks=(
        _seg("mlstm", 7),
        _seg("slstm", 1),
        _seg("mlstm", 7),
        _seg("slstm", 1),
        _seg("mlstm", 7),
        _seg("slstm", 1),
    ),
    remat="full",
)

_SMOKE_HEADS = AttnConfig(kind="gqa", n_heads=2, n_kv_heads=2, d_head=32)

SMOKE = ModelConfig(
    name="xlstm-smoke",
    d_model=64,
    vocab=256,
    blocks=(
        BlockConfig(kind="mlstm", n_layers=2, attn=_SMOKE_HEADS, d_ff=0),
        BlockConfig(kind="slstm", n_layers=1, attn=_SMOKE_HEADS, d_ff=0),
    ),
)
