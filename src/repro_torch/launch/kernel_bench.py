"""Kernel microbenchmark of the ODIN compute kernels: the fused stochastic
MAC array against its plain version and the int surrogate, the int8 GEMM,
and the structural op/byte model of the SC MAC at a large layer.

Each kernel's output is held against its plain version (sc_mac bit for
bit, int8_mm too) before it is timed.  Times come from CUDA
events on the card; with ``--device cpu`` they are host times of the plain
versions.  Prints one JSON object and writes no file:

    PYTHONPATH=src python -m repro_torch.launch.kernel_bench [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core import stochastic as sc
from repro_torch.core.odin_linear import get_luts
from repro_torch.device import resolve_device
from repro_torch.kernels.int8_mm import int8_mm_fused, int8_mm_ref
from repro_torch.kernels.sc_mac import sc_matmul_fused

__all__ = ["sc_mac_structure", "run", "main"]


def _time_ms(fn, device: torch.device, reps: int = 20) -> float:
    """Mean time of ``fn()`` after a warm-up: CUDA events on the card, the
    host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def sc_mac_structure(M, K, N, bm=8, bn=8, bk=256, W=8):
    """Per-tile op/byte model of the fused SC-MAC (the JAX benchmark's model:
    comparator SNG, AND, 3-op MUX nodes, popcount words)."""
    tiles = (M // bm) * (N // bn) * (K // bk)
    vmem = (bm * bk + bk * bn) * W * 4 + bm * bn * bk * W * 4
    bit_ops_per_tile = (
        bm * bk * W * 32 + bk * bn * W * 32          # comparator SNG
        + bm * bn * bk * W                           # AND
        + bm * bn * (bk - 1) * W * 3                 # MUX tree (2 AND + OR)
        + bm * bn * W                                # popcount words
    )
    hbm_bytes_per_tile = (bm * bk + bk * bn) * 4 + bm * bn * 4
    return dict(tiles=tiles, vmem_bytes=vmem,
                bit_ops=tiles * bit_ops_per_tile,
                hbm_bytes=tiles * hbm_bytes_per_tile,
                arithmetic_intensity=bit_ops_per_tile / hbm_bytes_per_tile,
                bit_ops_per_mac=bit_ops_per_tile / (bm * bn * bk))


def run(device=None, reps: int = 20) -> dict:
    dev = resolve_device(device)
    spec = sc.StreamSpec()
    lut_a, lut_w, selects = get_luts(256, 256, 0, device=dev)
    rng = np.random.default_rng(0)
    M, K, N = 16, 64, 16
    a = torch.as_tensor(rng.integers(0, 256, (M, K)), dtype=torch.int32, device=dev)
    w = torch.as_tensor(rng.integers(0, 256, (K, N)), dtype=torch.int32, device=dev)
    fused = sc_matmul_fused(a, w, lut_a, lut_w, selects, spec)
    if not torch.equal(fused, sc.sc_matmul(a, w, lut_a, lut_w, selects, spec)):
        raise AssertionError("sc_mac: fused popcounts differ from the plain sc_matmul")

    a8 = torch.as_tensor(rng.integers(-127, 128, (128, 256)), dtype=torch.int8, device=dev)
    w8 = torch.as_tensor(rng.integers(-127, 128, (256, 128)), dtype=torch.int8, device=dev)
    sa = torch.ones(128, dtype=torch.float32, device=dev)
    sw = torch.ones(128, dtype=torch.float32, device=dev)
    y8, ref8 = int8_mm_fused(a8, w8, sa, sw), int8_mm_ref(a8, w8, sa, sw)
    if not torch.equal(y8, ref8):
        raise AssertionError("int8_mm: kernel output differs from the plain version")

    return {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "timer": "cuda events" if dev.type == "cuda" else "host clock",
        "sc_matmul_plain_ms": _time_ms(
            lambda: sc.sc_matmul(a, w, lut_a, lut_w, selects, spec), dev, reps),
        "sc_matmul_fused_ms": _time_ms(
            lambda: sc_matmul_fused(a, w, lut_a, lut_w, selects, spec), dev, reps),
        "expected_int_surrogate_ms": _time_ms(lambda: sc.expected_matmul(a, w, spec), dev, reps),
        "int8_mm_fused_ms": _time_ms(lambda: int8_mm_fused(a8, w8, sa, sw), dev, reps),
        "sc_mac_structure": sc_mac_structure(512, 4096, 512),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device)))


if __name__ == "__main__":
    main()
