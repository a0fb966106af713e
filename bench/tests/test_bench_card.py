"""On the card: every cell of ``BENCHMARK.json`` at its own size through a
short window, correct, with a result line that meets the contract; and the
control — the reference in float8 in the program's place — failing each
cell's limits.  Skips without a card; run with
``python -m pytest -q bench/tests -m card``."""
import contextlib
import io
import json
import os

import pytest

from conftest import REPO, load_run_module

with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
    CELLS = [w["name"] for w in json.load(fh)["workloads"]]


@pytest.fixture(autouse=True)
def _free_the_card():
    """Each test at full size starts from a card its predecessor left empty."""
    yield
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell):
    mod = load_run_module()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mod.run(["--workload", cell, "--seed", "3000000901", "--seconds", "20",
                      "--trace", "0"], root=REPO)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True, line.get("checks")
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert list(line)[-1] == "checks"


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_on_the_card(card, cell):
    import time

    mod = load_run_module()
    mod._setup_paths(REPO)
    from harness import correct, serve, train

    _, _, cfg, traffic, limits = mod.load_cell(REPO, cell)
    seed = 3000000902
    if traffic["kind"] == "train":
        ref = correct.train_reference(cfg, traffic, seed, card)
        low = correct.train_reference(cfg, traffic, seed, card, "fp8")
        numbers = correct.compare_train(low, ref)
    else:
        rec = serve.run(cfg, traffic, seed, 30.0, False, card, time.perf_counter())
        _, numbers = correct.serve_numbers(rec, cfg, seed, card, control="fp8")
    assert not correct.judge(numbers, limits), numbers
