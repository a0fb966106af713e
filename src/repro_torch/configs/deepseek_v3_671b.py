"""deepseek-v3-671b — 61L d_model=7168, MLA, MoE 256e top-8 (+1 shared), MTP.

[arXiv:2412.19437; hf]  Exact paper dims: 3 dense layers then 58 MoE layers;
MLA with q_lora_rank=1536, kv_lora_rank=512, qk_nope=128, qk_rope=64,
v_head=128; routed experts d_ff=2048, dense/shared d_ff=18432 / 2048·1;
vocab 129280; aux-loss-free routing bias; multi-token prediction head.
"""
from repro_torch.configs.base import AttnConfig, BlockConfig, ModelConfig, MoEConfig

_MLA = AttnConfig(
    kind="mla",
    n_heads=128,
    n_kv_heads=128,
    d_head=128,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
)

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    d_model=7168,
    vocab=129_280,
    blocks=(
        BlockConfig(kind="dense", n_layers=3, attn=_MLA, d_ff=18_432),
        BlockConfig(
            kind="moe",
            n_layers=58,
            attn=_MLA,
            moe=MoEConfig(
                n_experts=256,
                top_k=8,
                d_ff=2_048,
                n_shared=1,
                capacity_factor=1.25,
                aux_free_bias=True,
            ),
        ),
    ),
    mtp=True,
    remat="full",
)

SMOKE = ModelConfig(
    name="deepseek-v3-smoke",
    d_model=64,
    vocab=256,
    blocks=(
        BlockConfig(
            kind="dense",
            n_layers=1,
            attn=AttnConfig(
                kind="mla", n_heads=4, n_kv_heads=4, d_head=16, q_lora_rank=32,
                kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
            ),
            d_ff=128,
        ),
        BlockConfig(
            kind="moe",
            n_layers=2,
            attn=AttnConfig(
                kind="mla", n_heads=4, n_kv_heads=4, d_head=16, q_lora_rank=32,
                kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
            ),
            moe=MoEConfig(n_experts=8, top_k=2, d_ff=32, n_shared=1),
        ),
    ),
    mtp=True,
)
