"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` source has a plain C interface and compiles, for Hopper
(``sm_90a``), into its own shared library under ``build/kernels/`` at the
repository root.  The library's file name carries a hash of the source and
the flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing is built when a module is imported: a wrapper builds its kernel on
its first launch, and ``chip_smoke.py`` builds them all up front, in
parallel.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "build_all", "load"]

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


def build_all(sources) -> dict:
    """Compile every source whose library does not exist yet, one ``nvcc``
    each, all started together; returns each source's compiler output
    (``-Xptxas -v`` lists registers and spills), empty when reused."""
    sources = [Path(s) for s in sources]
    texts = {s: "" for s in sources}
    running = []
    for source in sources:
        out = _target(source)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((source, proc, tmp, out))
    failed = []
    for source, proc, tmp, out in running:
        texts[source] = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"nvcc failed for {source} (exit {proc.returncode}):\n"
                          f"{texts[source]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return texts


def build(source: Path) -> str:
    """Compile one source unless its library exists (see :func:`build_all`)."""
    return build_all([source])[Path(source)]


@functools.cache
def load(source: Path) -> ctypes.CDLL:
    """The loaded shared library of one source, built first if needed."""
    build(source)
    return ctypes.CDLL(str(_target(Path(source))))
