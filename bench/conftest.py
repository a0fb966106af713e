"""pytest settings of the benchmark's own tests (``bench/tests``).

Run them from the repository root: ``python -m pytest -q bench/tests``
(CPU, tiny fixture configurations), and on a machine with a card the
card-marked ones too: ``python -m pytest -q bench/tests -m card``.
"""
import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(BENCH)
for p in (os.path.join(REPO, "src"), BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

# the fixture cells: (cell, configuration, traffic), each added as new files
FIXTURE_CELLS = (("tiny.chat", "tiny-dense", "tiny-chat"),
                 ("tinymoe.chat", "tiny-moe", "tiny-chat"),
                 ("tiny.train", "tiny-dense", "tiny-train"))
FIXTURE_LIMITS = {"tiny.chat": {"logit_gap": 0.25},
                  "tinymoe.chat": {"logit_gap": 2.0, "logit_gap_mean": 0.03},
                  "tiny.train": {"loss_gap": 0.01, "grad_norm_gap": 0.05,
                                 "change_norm_gap": 0.1}}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """The card's device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def make_root(tmp) -> str:
    """A checkout-shaped copy of the benchmark with the fixture cells added
    the way a later change adds a cell: new configuration, traffic and
    limits files, and new entries in ``BENCHMARK.json``'s lists."""
    tmp = str(tmp)
    shutil.copytree(BENCH, os.path.join(tmp, "bench"),
                    ignore=shutil.ignore_patterns("__pycache__", ".pytest_cache"))
    os.symlink(os.path.join(REPO, "src"), os.path.join(tmp, "src"))
    fx = os.path.join(tmp, "bench", "tests", "fixtures")
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    for name in ("tiny-dense", "tiny-moe"):
        shutil.copy(os.path.join(fx, f"{name}.json"),
                    os.path.join(tmp, "bench", "configs", f"{name}.json"))
        bench["configs"].append({"name": name, "source": "test fixture",
                                 "file": f"bench/configs/{name}.json", "reduced": [],
                                 "why": "test fixture"})
    for name in ("tiny-chat", "tiny-train"):
        shutil.copy(os.path.join(fx, f"{name}.json"),
                    os.path.join(tmp, "bench", "traffic", f"{name}.json"))
    for cell, conf, traffic in FIXTURE_CELLS:
        bench["workloads"].append({"name": cell, "config": conf, "traffic": traffic,
                                   "chips": 1, "why": "test fixture"})
        with open(os.path.join(tmp, "bench", "limits", f"{cell}.json"), "w") as fh:
            json.dump(FIXTURE_LIMITS[cell], fh)
        train = "train" in traffic
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" not in m:
                continue
            kinds = {"train" in w for w in m["workloads"]}
            if train in kinds:
                m["workloads"].append(cell)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    return tmp


@pytest.fixture(scope="session")
def bench_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("checkout"))


def load_run_module():
    import importlib.util

    spec = importlib.util.spec_from_file_location("bench_run", os.path.join(BENCH, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
