"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` source has a plain C interface and compiles, for Hopper
(``sm_90a``), into its own shared library under ``build/kernels/`` at the
repository root.  The library's file name carries a hash of the source and
the flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing is built when a module is imported: a wrapper builds its kernel on
its first launch, and ``chip_smoke.py`` builds them up front.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "load"]

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _target(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:12]}.so"


def build(source: Path) -> str:
    """Compile ``source`` unless its library exists; returns the compiler's
    output (``-Xptxas -v`` lists registers and spills), empty when reused."""
    source = Path(source)
    out = _target(source)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {source} (exit {proc.returncode}):\n"
                           f"{proc.stdout}")
    os.replace(tmp, out)
    return proc.stdout


@functools.cache
def load(source: Path) -> ctypes.CDLL:
    """The loaded shared library of one source, built first if needed."""
    build(source)
    return ctypes.CDLL(str(_target(Path(source))))
