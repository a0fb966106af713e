"""The readers of the engine's host phases and the program's profiler ranges
against hand-built records: known values, and nothing to read in a record
without the span fields or the range rows (a program that records neither)."""
import importlib.util
import os

import pytest

from conftest import BENCH


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), os.path.join(BENCH, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def phases(plan, pack, upload, enqueue, sync, emit):
    return {"plan_s": plan, "pack_s": pack, "upload_s": upload, "enqueue_s": enqueue,
            "sync_s": sync, "emit_s": emit}


# a serving window 100 → 110 s, the profiler over its last 2 s: the span at
# 108.5 s and the horizon span fall outside what the span readers take
SPANS = [
    {"name": "mixed", "ts": 101.0, "dur": 0.5,
     "args": {"rows": 10, "q_tile": 8, **phases(0.004, 0.001, 0.002, 0.100, 0.398, 0.005)}},
    {"name": "decode", "ts": 102.0, "dur": 0.1,
     "args": {"rows": 2, **phases(0.001, 0.0, 0.001, 0.020, 0.079, 0.002)}},
    {"name": "horizon", "ts": 103.0, "dur": 0.2,
     "args": {"rows": 8, **phases(0.5, 0.5, 0.0, 0.5, 0.0, 0.5)}},
    {"name": "mixed", "ts": 108.5, "dur": 0.9,
     "args": {"rows": 1, "q_tile": 64, **phases(1.0, 1.0, 0.0, 1.0, 0.0, 1.0)}},
]
PROFILE = {"t0": 108.0, "t1": 110.0, "window_s": 2.0, "busy_s": 1.5, "kernel_s": {},
           "op_rows": [("serving/enqueue", [], 1.4, 4), ("attn/core", [], 0.6, 64),
                       ("aten::bmm", [8, 4, 64], 0.3, 10), ("optim/adamw", [], 0.9, 2)],
           "breakdown": {"device_ops": [], "idle_gaps": []}}
SERVE = {"kind": "serve", "t0": 100.0, "t1": 110.0, "requests": [], "spans": SPANS,
         "profile": PROFILE}
TRAIN = {"kind": "train", "t0": 0.0, "t1": 10.0, "steps": [],
         "profile": {**PROFILE, "t0": 7.0, "t1": 10.0, "busy_s": 2.7}}


def ctx(record):
    return {"record": record, "dims": {}, "traffic": {"engine": {"slots": 2}}}


def test_phase_readers_by_hand():
    # plan + pack + emit of the first mixed and the decode span
    assert reader("engine_host_ms")(ctx(SERVE)) == pytest.approx(1e3 * (0.010 + 0.003) / 2)
    assert reader("dispatch_enqueue_ms")(ctx(SERVE)) == pytest.approx(1e3 * (0.100 + 0.020) / 2)


def test_range_readers_by_hand():
    assert reader("attn_core_share")(ctx(SERVE)) == pytest.approx(100 * 0.6 / 1.5)
    assert reader("adamw_share")(ctx(TRAIN)) == pytest.approx(100 * 0.9 / 2.7)
    # each reads its own kind of window
    assert reader("attn_core_share")(ctx(TRAIN)) is None
    assert reader("adamw_share")(ctx(SERVE)) is None


@pytest.mark.parametrize("name", ["engine_host_ms", "dispatch_enqueue_ms"])
def test_phase_readers_find_nothing_without_the_fields(name):
    bare = [{**s, "args": {"rows": s["args"]["rows"]}} for s in SPANS]
    assert reader(name)(ctx({**SERVE, "spans": bare})) is None
    assert reader(name)(ctx({k: v for k, v in SERVE.items() if k != "spans"})) is None


@pytest.mark.parametrize("name,record", [("attn_core_share", SERVE), ("adamw_share", TRAIN)])
def test_range_readers_find_nothing_without_the_rows(name, record):
    rows = [r for r in PROFILE["op_rows"] if r[0] not in ("attn/core", "optim/adamw")]
    assert reader(name)(ctx({**record, "profile": {**record["profile"], "op_rows": rows}})) is None
    assert reader(name)(ctx({k: v for k, v in record.items() if k != "profile"})) is None
    idle = {**record["profile"], "busy_s": 0.0}
    assert reader(name)(ctx({**record, "profile": idle})) is None
