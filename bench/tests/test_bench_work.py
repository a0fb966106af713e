"""The FLOP and byte counts of ``bench/work`` against hand counts at the
two configurations' published widths."""
import json
import os

import pytest

from conftest import BENCH
from reference.weights import dims, param_count
from work.model_step import attn_flops, head_flops, linear_flops_per_token, train_flops
from work.paged_attn import decode_row_bytes


def config(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as fh:
        return dims(json.load(fh))


def test_phi4_counts():
    m = config("phi4-mini-3.8b")
    # per layer: q, k, v, o = 3072² + 2·3072·1024 + 3072²; SwiGLU 3·3072·8192
    layer = 9_437_184 + 6_291_456 + 9_437_184 + 75_497_472
    assert layer * 32 == 3_221_225_472
    assert linear_flops_per_token(m) == 2 * 3_221_225_472
    assert head_flops(m) == 2 * 3072 * 200_064
    # one decode row at a 4,096-token context: QKᵀ and PV over 24 heads of 128
    assert attn_flops(m, 4095, 1) == 4 * 32 * 24 * 128 * 4096
    # its K/V (8 heads of 128, bf16), q and out (24 heads), 256 table entries
    assert decode_row_bytes(m, 4096, 16) == 32 * (2 * 4096 * 8 * 128 * 2 + 2 * 24 * 128 * 2
                                                   + 4 * 256)
    # a 4 x 2048 step: 6 × (projections + head) × tokens + 3 × causal attention
    keys = 2048 * 2049 // 2
    assert train_flops(m, 4, 2048) == pytest.approx(
        6 * (3_221_225_472 + 3072 * 200_064) * 8192 + 3 * 4 * 4 * 32 * 24 * 128 * keys)
    # 3.84 B parameters, as published: the head is the embedding, norm gains counted
    with open(os.path.join(BENCH, "configs", "phi4-mini-3.8b.json")) as fh:
        assert param_count(json.load(fh)) == 200_064 * 3072 + 32 * (100_663_296 + 2 * 3072) + 3072


def test_qwen3_counts():
    m = config("qwen3-moe-235b-a22b-8L")
    attn = 4096 * 8192 + 2 * 4096 * 512 + 8192 * 4096          # 64 query, 4 KV heads of 128
    active = 4096 * 128 + 8 * 3 * 4096 * 1536                   # router + 8 of 128 experts
    assert linear_flops_per_token(m) == 2 * 8 * (attn + active) == 3_565_158_400
    assert attn_flops(m, 0, 1024) == 4 * 8 * 64 * 128 * (1024 * 1025 // 2)
    assert decode_row_bytes(m, 1000, 16) == 8 * (2 * 1000 * 4 * 128 * 2 + 2 * 64 * 128 * 2
                                                  + 4 * 63)
    # 21.1 B parameters, 42.3 GB in bfloat16
    assert param_count({**json.load(open(os.path.join(BENCH, "configs",
                                                      "qwen3-moe-235b-a22b-8L.json")))}) \
        == pytest.approx(21.1e9, rel=0.01)
