"""The port's training loop and CLI (``repro_torch/launch/train.py``) on the CPU:
resume exactness (10 straight steps == 5 + restart + 5, as
``tests/test_checkpoint.py``), a crash without a checkpoint and a relaunch
through the CLI (``python -m repro_torch.launch.train``, subprocesses), and
``tests/test_system.py``'s learning checks on its ``SMALL_LM`` with float32
and int8 AdamW moments."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import AttnConfig, BlockConfig, ModelConfig
from repro_torch.launch.train import train_loop
from repro_torch.models import registry
from repro_torch.optim.adamw import AdamWConfig

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

@pytest.fixture(autouse=True)
def _two_threads():
    """These models are tiny: their steps gain nothing from more than two
    intra-op threads, and the suite runs several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


SMALL_LM = ModelConfig(
    name="tiny", d_model=128, vocab=512,
    blocks=(BlockConfig(kind="dense", n_layers=2,
                        attn=AttnConfig(n_heads=4, n_kv_heads=2, d_head=32),
                        d_ff=256),),
)


def test_train_resume_exactness(tmp_path):
    """xlstm's smoke config: the losses of steps 5-9 of a straight run equal
    those of a run that stopped after step 4 and resumed from its
    checkpoint (the same bits: one process, the same CPU kernels)."""
    cfg = registry.get_smoke("xlstm-350m")
    kw = dict(batch=2, seq=32, save_every=5, seed=7,
              opt_cfg=AdamWConfig(moment_dtype="float32"), device="cpu")
    _, straight = train_loop(cfg, steps=10, ckpt_dir=str(tmp_path / "a"), **kw)
    d2 = str(tmp_path / "b")
    train_loop(cfg, steps=5, ckpt_dir=d2, **kw)
    _, resumed = train_loop(cfg, steps=10, ckpt_dir=d2, resume=True, **kw)
    assert resumed == straight[5:]


@pytest.mark.slow
def test_crash_and_relaunch(tmp_path):
    """The port's CLI: a crash at step 9 leaves the step-8 checkpoint (exit
    137, no save); the relaunch with ``--resume`` finishes at step 12."""
    d = str(tmp_path / "run")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC), OMP_NUM_THREADS="2")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "xlstm-350m",
            "--smoke", "--device", "cpu", "--batch", "2", "--seq", "32", "--ckpt-dir", d,
            "--save-every", "4", "--steps", "12"]
    p = subprocess.run(base + ["--simulate-crash-at", "9"], env=env, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 137, p.stdout + p.stderr
    assert ckpt.latest_step(d) == 8
    p2 = subprocess.run(base + ["--resume"], env=env, capture_output=True, text=True,
                        timeout=600)
    assert p2.returncode == 0, p2.stdout + p2.stderr
    assert "resumed from step 8" in p2.stdout
    assert ckpt.latest_step(d) == 12


def _learns(losses, frac):
    head = sum(losses[:5]) / 5
    tail = sum(losses[-5:]) / 5
    assert tail < frac * head, (head, tail)


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_lm_training_learns(tmp_path, moments):
    """``tests/test_system.py``: 100 steps of 8 x 64 tokens at lr 2e-3 cut the
    loss by more than 12 % (the synthetic mixture needs in-context
    induction, so the drop is steady, not a collapse)."""
    _, losses = train_loop(SMALL_LM, steps=100, batch=8, seq=64, ckpt_dir=str(tmp_path),
                           save_every=1000, opt_cfg=AdamWConfig(moment_dtype=moments),
                           base_lr=2e-3, log_every=1000, device="cpu")
    assert np.isfinite(losses).all()
    _learns(losses, 0.88)
