"""The port's dry-run and its step analysis (``launch/dryrun.py``,
``launch/hlo.py``): the roofline against the JAX package's formula, the
counter's FLOPs on plain and sharded products, every arch's smoke
``train_4k`` cell OK on a 2 × 2 fake mesh, the records read by the untouched
``benchmarks/roofline.py``, and the CLI.

A fake process group is process-global: each test that needs one opens and
closes it (``dryrun.fake_group``), so nothing leaks into other test files of
the same worker.
"""
import json
import os
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.launch import hlo as jhlo  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun, hlo  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import registry  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
KEYS = ("status", "arch", "shape", "multi_pod")
OK_KEYS = ("memory", "cost", "collectives", "roofline", "fits_hbm", "n_devices",
           "model_flops", "params", "mesh")


@pytest.mark.parametrize("flops,bytes_,coll", [
    (1e15, 1e12, 1e9), (1e12, 1e13, 1e9), (1e12, 1e9, 1e13), (0.0, 0.0, 0.0),
])
def test_roofline_terms_match_jax(flops, bytes_, coll):
    hw = hlo.HW()
    jhw = jhlo.HW(peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bw, ici_bw=hw.ici_bw,
                  hbm_bytes=hw.hbm_bytes)
    assert hlo.roofline_terms(flops, bytes_, coll, hw) == jhlo.roofline_terms(
        flops, bytes_, coll, jhw)
    assert hlo.parse_dtype_bytes("bfloat16") == jhlo.parse_dtype_bytes("bf16") == 2
    assert hlo.parse_dtype_bytes(torch.float32) == jhlo.parse_dtype_bytes("f32") == 4


def test_counter_counts_each_product_as_it_runs():
    """2·M·N·K a product, every iteration of a Python loop counted: 2n
    products count twice n; bytes are operands + results."""
    a, b = torch.ones(8, 16), torch.ones(16, 4)

    def loop(n):
        with hlo.CostCounter() as c:
            for _ in range(n):
                torch.matmul(a, b)
        return c.costs()

    c3, c6 = loop(3), loop(6)
    assert c3.flops == 3 * 2 * 8 * 4 * 16 and c6.flops / c3.flops == 2.0
    assert c3.memory_bytes == 3 * 4 * (8 * 16 + 16 * 4 + 8 * 4)
    with hlo.CostCounter() as c:
        torch.bmm(torch.ones(3, 5, 7), torch.ones(3, 7, 2))
        torch.addmm(torch.ones(5, 2), torch.ones(5, 7), torch.ones(7, 2))
    assert c.costs().flops == 2 * 3 * 5 * 2 * 7 + 2 * 5 * 2 * 7


def test_counter_counts_a_sharded_product_per_rank():
    """``[256, 4096, 8192] @ [8192, 16384]`` on a 512-rank fake mesh: the
    counter sees each rank's local product (a FLOP counter above DTensor
    would count the global one), and the weight's all-gather."""
    from torch.distributed.tensor import Replicate, Shard

    with dryrun.fake_group(512):
        mesh = make_mesh((2, 16, 16), ("pod", "data", "model"), "cpu")
        x = dryrun._fake((256, 4096, 8192), torch.bfloat16, mesh, (("pod", "data"),))
        w = dryrun._fake((8192, 16384), torch.bfloat16, mesh, ("data", "model"))
        with hlo.CostCounter() as c:
            y = torch.matmul(x, w)
        costs = c.costs()
    assert tuple(y.placements) == (Shard(0), Shard(0), Shard(2))
    assert costs.flops == 2 * (256 // 32) * 4096 * (16384 // 16) * 8192   # 5.5e11, not 2.8e14
    assert costs.collectives["all-gather"] == 8192 * 16384 * 2 / 256
    assert Replicate() not in y.placements


@pytest.fixture(scope="module")
def smoke_records():
    recs = {}
    with dryrun.fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        for arch in registry.ARCH_IDS:
            recs[arch] = dryrun.run_cell(arch, "train_4k", mesh=mesh, smoke=True)
    return recs


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_smoke_train_cell_on_a_2x2_fake_mesh(smoke_records, arch):
    """Every arch's smoke train cell traces OK (the MoE dispatch, Hymba's
    SSM and xLSTM's cells on DTensors, the int8 moments on sharded leaves)
    and its record is well-formed."""
    rec = smoke_records[arch]
    json.dumps(rec, allow_nan=False)
    assert all(k in rec for k in KEYS), rec
    assert rec["status"] == "OK", rec.get("error")
    assert all(k in rec for k in OK_KEYS)
    mem, cost, roof = rec["memory"], rec["cost"], rec["roofline"]
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0
    # AdamW updates in place: the outputs are the inputs, but for the metrics
    assert 0 < mem["output_bytes"] - mem["alias_bytes"] <= 64
    assert mem["total_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                  + mem["temp_bytes"] - mem["alias_bytes"])
    assert cost["flops"] > 0 and cost["bytes_accessed"] > 0
    assert cost["n_collectives"] == cost["comm_debug_collectives"] > 0
    assert rec["collectives"]["total"] > 0 and rec["n_devices"] == 4
    assert roof["bottleneck"] in ("compute", "memory", "collective")
    assert 0 < roof["useful_flops_ratio"] and rec["fits_hbm"]


def test_roofline_bench_reads_the_port_records(smoke_records, tmp_path):
    sys.path.insert(0, ROOT)
    from benchmarks import roofline

    for arch, rec in smoke_records.items():
        with open(tmp_path / (dryrun.cell_id(arch, "train_4k", False) + ".json"), "w") as f:
            json.dump(rec, f)
    rows = roofline.run(verbose=False, dryrun_dir=str(tmp_path))
    ok = sorted(a for a, r in smoke_records.items() if r["status"] == "OK")
    assert sorted(r["arch"] for r in rows) == ok == sorted(registry.ARCH_IDS)


def test_counter_same_on_real_and_meta_tensors():
    """One sharded train step on a 1 × 1 mesh: the same FLOPs, bytes and op
    count whether the shards are real (here on the CPU) or meta."""
    cfg = registry.get_smoke("phi4-mini-3.8b")
    shape = ShapeConfig("t", 32, 2, "train")
    with dryrun.fake_group(1):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        real, _, metrics = dryrun.step_costs(cfg, shape, mesh, device="cpu")
        fake, _, _ = dryrun.step_costs(cfg, shape, mesh, device="meta")
    assert torch.isfinite(metrics["loss"])
    assert (real.flops, real.memory_bytes, real.n_ops) == (fake.flops, fake.memory_bytes,
                                                           fake.n_ops)
    assert real.flops > 0


def test_cli_writes_records_and_fails_loudly(tmp_path, monkeypatch, capsys):
    out = str(tmp_path / "dr")
    dryrun.main(["--arch", "phi4-mini-3.8b", "--shape", "long_500k", "--out", out])
    assert "SKIP" in capsys.readouterr().out
    calls = []

    def fake_run_cell(arch, shape, multi_pod=False, **kw):
        calls.append((arch, shape, multi_pod))
        return {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                "status": "LOWER_FAILED", "error": "RuntimeError: boom", "trace": ""}

    monkeypatch.setattr(dryrun, "run_cell", fake_run_cell)
    with pytest.raises(SystemExit, match="2 cell"):
        dryrun.main(["--arch", "hymba-1.5b", "--shape", "decode_32k", "--multi-pod", "both",
                     "--out", out])
    assert calls == [("hymba-1.5b", "decode_32k", False), ("hymba-1.5b", "decode_32k", True)]
    with open(os.path.join(out, "hymba-1.5b__decode_32k__pod2.json")) as f:
        assert json.load(f)["status"] == "LOWER_FAILED"
