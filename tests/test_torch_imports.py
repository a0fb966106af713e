"""Import hygiene of the port: every module of ``repro_torch``, and the
root ``chip_smoke.py`` that drives it on the card, import in a fresh
interpreter without pulling in JAX or any module of the JAX package."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")

SCRIPT = r"""
import importlib, importlib.util, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, prefix="repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", CHIP_SMOKE)
chip_smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(chip_smoke)          # defines main() but does not run it
assert callable(chip_smoke.main)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
assert len(names) > 20, names
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    script = f"CHIP_SMOKE = {os.path.abspath(os.path.join(ROOT, 'chip_smoke.py'))!r}\n" + SCRIPT
    out = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
