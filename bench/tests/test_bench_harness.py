"""The harness end to end on the CPU, at the fixture configurations' size:
the result line of every fixture cell (added as new files only), the
planted faults that ``correct`` has to catch, and the refusals."""
import contextlib
import io
import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH, FIXTURE_CELLS, REPO, load_run_module, make_root

KEYS = ("correct", "attempted", "failed", "metrics", "device")


def run_cell(root, cell, trace=0, seed=3_000_000_017, seconds=2.0):
    """One CPU run of ``cell``: (exit code, last stdout line as JSON or None, stderr)."""
    mod = load_run_module()
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.run(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                      "--trace", str(trace)], root=root, device="cpu")
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


def _expected(root, cell, trace):
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return {m["name"]: m for m in group if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [c for c, _, _ in FIXTURE_CELLS])
def test_result_line_meets_the_contract(bench_root, cell, trace):
    rc, line, err = run_cell(bench_root, cell, trace)
    assert rc == 0, err
    assert all(k in line for k in KEYS)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    want = _expected(bench_root, cell, trace)
    assert set(line["metrics"]) <= set(want)
    for name, m in line["metrics"].items():
        assert m["unit"] == want[name]["unit"]
        assert isinstance(m["value"], float)
    if trace:
        # the CPU has no device trace: the device readers find nothing
        assert line["device"]["window_s"] > 0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == set(want)
    dev = line["device"]
    assert (dev["platform"], dev["count"]) == ("cpu", 1)
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") for t in tail)


@pytest.mark.parametrize("cell", ["tiny.chat", "tinymoe.chat"])
def test_a_token_altered_where_it_is_produced_fails(bench_root, cell, monkeypatch):
    from repro_torch.serving.engine import ServingEngine

    real = ServingEngine._emit

    def altered(self, req, tok, now):
        if req.n_generated == 2:
            tok = (tok + 128) % 256
        return real(self, req, tok, now)

    monkeypatch.setattr(ServingEngine, "_emit", altered)
    rc, line, _ = run_cell(bench_root, cell)
    assert rc == 0 and line["correct"] is False, line["checks"]


def _wrap_step(monkeypatch, wrap):
    from harness import train

    real = train.make_train_step
    monkeypatch.setattr(train, "make_train_step", lambda *a, **k: wrap(real(*a, **k)))


def test_a_step_that_returns_its_state_unchanged_fails(bench_root, monkeypatch):
    def unchanged(step):
        def same(params, opt, batch):
            import copy
            import torch

            p0 = [t.detach().clone() for t in _leaves(params)]
            o0 = copy.deepcopy(opt)
            params, opt, met = step(params, opt, batch)
            with torch.no_grad():
                for t, s in zip(_leaves(params), p0):
                    t.copy_(s)
            return params, o0, met
        return same

    _wrap_step(monkeypatch, unchanged)
    rc, line, _ = run_cell(bench_root, "tiny.train")
    assert rc == 0 and line["correct"] is False, line["checks"]
    assert line["checks"]["change_norm_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_fails(bench_root, monkeypatch):
    def half(step):
        def on_half(params, opt, batch):
            rows = batch["tokens"].shape[0] // 2
            return step(params, opt, {k: v[:rows] for k, v in batch.items()})
        return on_half

    _wrap_step(monkeypatch, half)
    rc, line, _ = run_cell(bench_root, "tiny.train")
    assert rc == 0 and line["correct"] is False, line["checks"]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_a_loaded_jax_module_refuses_the_run(bench_root, monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, line, err = run_cell(bench_root, "tiny.chat")
    assert rc != 0 and line is None
    assert "jax" in err


def _cli(cwd, *extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "bench/run.py", "--workload", "phi4-mini.rag",
                           "--seed", "5", "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_without_a_card_the_run_refuses_and_prints_no_result():
    proc = _cli(REPO)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_a_directory_of_the_benchmark_alone_refuses(tmp_path):
    import shutil

    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".pytest_cache"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    proc = _cli(str(tmp_path))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_a_fixture_cell_needs_no_edit_of_an_existing_file(tmp_path):
    root = make_root(tmp_path)
    for sub in ("configs", "traffic", "limits", "metrics", "work", "reference", "harness"):
        for name in os.listdir(os.path.join(BENCH, sub)):
            path = os.path.join(BENCH, sub, name)
            if os.path.isfile(path):
                with open(path, "rb") as a, open(os.path.join(root, "bench", sub, name), "rb") as b:
                    assert a.read() == b.read(), path
    for f in ("run.py",):
        with open(os.path.join(BENCH, f), "rb") as a, open(os.path.join(root, "bench", f), "rb") as b:
            assert a.read() == b.read()
    rc, line, _ = run_cell(root, "tiny.chat", seconds=1.0)
    assert rc == 0 and line["correct"] is True
