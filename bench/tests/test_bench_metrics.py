"""Every metric reader against a recorded run fixture, values by hand."""
import importlib.util
import math
import os

import pytest

from conftest import BENCH

PEAK = 989e12


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), os.path.join(BENCH, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


DENSE = {"d": 64, "V": 256, "L": 2, "H": 4, "Hkv": 2, "D": 16, "F": 128, "moe": False}
MOE = {**DENSE, "moe": True, "E": 8, "top_k": 2, "F": 32}

# a serving window 100 → 110 s, the profiler over its last 2 s
SERVE = {
    "kind": "serve", "t0": 100.0, "t1": 110.0, "setup_s": 42.5, "block_size": 16,
    "memory_peak_bytes": 1,
    "requests": [
        {"rid": 1, "t_submit": 99.0, "times": [101.0, 102.0, 103.0, 109.0], "prompt_len": 100,
         "max_new": 4, "state": "done"},
        {"rid": 2, "t_submit": 104.0, "times": [105.0, 109.5], "prompt_len": 50,
         "max_new": 2, "state": "done"},
        {"rid": 3, "t_submit": 106.0, "times": [], "prompt_len": 30, "max_new": 2,
         "state": "failed"},
    ],
    "prefill_rows": [(101.0, 0, 64), (102.0, 64, 36), (109.0, 0, 50)],
    "spans": [
        {"name": "mixed", "ts": 101.0, "dur": 0.5, "args": {"rows": 10, "q_tile": 8}},
        {"name": "decode", "ts": 102.0, "dur": 0.1, "args": {"rows": 2}},
        {"name": "mixed", "ts": 103.0, "dur": 0.3, "args": {"rows": 4, "q_tile": 4}},
        {"name": "mixed", "ts": 108.5, "dur": 0.9, "args": {"rows": 1, "q_tile": 64}},
    ],
    "profile": {
        "t0": 108.0, "t1": 110.0, "window_s": 2.0, "busy_s": 1.5,
        "kernel_s": {"void paged_attn_split_kernel<128>": 0.010,
                     "paged_attn_combine_kernel": 0.002, "nvjet_gemm": 1.0},
        "op_rows": [("aten::bmm", [8, 4, 64], 0.6, 10), ("aten::bmm", [2, 3, 4], 0.1, 5),
                    ("aten::mm", [4, 4], 0.2, 3)],
        "breakdown": {"device_ops": [], "idle_gaps": []}},
}
TRAIN = {
    "kind": "train", "t0": 0.0, "t1": 10.0, "setup_s": 7.0, "memory_peak_bytes": 1,
    "tokens_per_step": 32,
    "steps": [(2.0, 5.0, False), (4.0, 5.0, False), (6.0, 5.0, False), (9.0, 5.0, True)],
    "profile": {"t0": 7.0, "t1": 10.0, "window_s": 3.0, "busy_s": 2.7, "kernel_s": {},
                "op_rows": [], "breakdown": {}},
}


def ctx(record, dims=DENSE, traffic=None):
    return {"record": record, "dims": dims,
            "traffic": traffic or {"engine": {"slots": 2}, "batch": 2, "seq": 16}}


def test_end_to_end_readers():
    assert reader("setup_s")(ctx(SERVE)) == 42.5
    assert reader("output_tok_s")(ctx(SERVE)) == pytest.approx(6 / 10)
    # first tokens 2 s and 1 s after submit, the failed request infinite
    assert reader("ttft_p50_s")(ctx(SERVE)) == pytest.approx(2.0)
    # gaps 1, 1, 6 and 4.5: the 95th percentile interpolates 4.5 → 6 at 0.85
    assert reader("itl_p95_s")(ctx(SERVE)) == pytest.approx(5.775)
    assert reader("train_tok_s")(ctx(TRAIN)) == pytest.approx(4 * 32 / 10)
    assert reader("output_tok_s")(ctx(TRAIN)) is None
    assert reader("train_tok_s")(ctx(SERVE)) is None


def test_span_readers_take_the_unprofiled_stretch():
    assert reader("mixed_tile_fill")(ctx(SERVE)) == pytest.approx(100 * 14 / (2 * 8 + 2 * 4))
    assert reader("mixed_dispatch_ms")(ctx(SERVE)) == pytest.approx(400.0)
    bare = {**SERVE, "spans": []}
    assert reader("mixed_tile_fill")(ctx(bare)) is None
    assert reader("mixed_dispatch_ms")(ctx(bare)) is None


def test_step_mfu_serve_by_hand():
    lin = 2 * 2 * (64 * 64 + 2 * 64 * 32 + 64 * 64 + 3 * 64 * 128)      # 147,456 a token
    per_key = 4 * 2 * 4 * 16
    keys = 64 * 65 // 2 + (100 * 101 - 64 * 65) // 2 + 101 + 102       # two chunks, two decodes
    flops = lin * (64 + 36 + 2) + per_key * keys + 4 * 2 * 64 * 256
    assert flops == 17_861_120
    assert reader("step_mfu.serve")(ctx(SERVE)) == pytest.approx(100 * flops / (8 * PEAK))


def test_step_mfu_train_by_hand():
    per_step = 6 * (147_456 // 2 + 64 * 256) * 32 + 3 * 2 * 4 * 2 * 4 * 16 * (16 * 17 // 2)
    assert per_step == 17_719_296
    assert reader("step_mfu.train")(ctx(TRAIN)) == pytest.approx(100 * 3 * per_step / (7 * PEAK))


def test_device_readers():
    # decode rows in the profile: contexts 103 and 51
    row = lambda c: 2 * (2 * c * 2 * 16 * 2 + 2 * 4 * 16 * 2 + 4 * math.ceil(c / 16))
    assert row(103) + row(51) == 40_536
    assert reader("paged_attn_roofline")(ctx(SERVE)) == pytest.approx(
        100 * 40_536 / 3.35e12 / 0.012)
    assert reader("moe_expert_share")(ctx(SERVE, MOE)) == pytest.approx(100 * 0.6 / 1.5)
    assert reader("moe_expert_share")(ctx(SERVE)) is None
    assert reader("device_idle_share.serve")(ctx(SERVE)) == pytest.approx(25.0)
    assert reader("device_idle_share.train")(ctx(TRAIN)) == pytest.approx(10.0)
    assert reader("device_idle_share.train")(ctx(SERVE)) is None
    unprofiled = {k: v for k, v in SERVE.items() if k != "profile"}
    for name in ("paged_attn_roofline", "moe_expert_share", "device_idle_share.serve"):
        assert reader(name)(ctx(unprofiled, MOE)) is None
    no_kernel = {**SERVE, "profile": {**SERVE["profile"], "kernel_s": {"nvjet_gemm": 1.0}}}
    assert reader("paged_attn_roofline")(ctx(no_kernel)) is None


def test_every_metric_of_the_benchmark_has_a_reader():
    import json

    with open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH, "metrics", f"{m['name']}.py")), m["name"]
