#!/usr/bin/env python3
"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card it is started on: the
cell's configuration (``bench/configs/``) under its traffic
(``bench/traffic/<traffic>.json``), measured for ``--seconds`` after the
set-up, then held against the plain reference (``bench/reference/``) by
the limits of ``bench/limits/<cell>.json``.  With ``--trace 0`` the result
line carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, each read from the run's record by
``bench/metrics/<metric>.py``.  The last line of standard output is the
result; the numbers compared, each beside its limit, close both it and
standard error.

Exits non-zero, printing no result, without enough CUDA devices, when a
module of JAX or of the JAX package is loaded, or outside a checkout that
holds the port (``src/repro_torch``).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _setup_paths(root: str) -> None:
    """The benchmark's and the port's sources on the path, and every build
    cache of the program at a fixed place inside the checkout."""
    for p in (os.path.join(root, "src"), os.path.join(root, "bench")):
        if p not in sys.path:
            sys.path.insert(0, p)
    build = os.path.join(root, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")


def forbidden_modules():
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def _reader(root: str, name: str):
    path = os.path.join(root, "bench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_cell(root: str, workload: str):
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"unknown workload {workload!r}")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, conf["file"])) as fh:
        cfg = json.load(fh)
    with open(os.path.join(root, "bench", "traffic", f"{cell['traffic']}.json")) as fh:
        traffic = json.load(fh)
    with open(os.path.join(root, "bench", "limits", f"{workload}.json")) as fh:
        limits = json.load(fh)
    return bench, cell, cfg, traffic, limits


def _metrics_of(bench, cell, trace: bool):
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell["name"] in m.get("workloads", [cell["name"]])]


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run(argv=None, root: str = ROOT, device=None) -> int:
    """One run.  ``device`` other than None skips the look for a card (the
    tests' CPU runs)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _setup_paths(root)
    import torch

    bench, cell, cfg, traffic, limits = load_cell(root, args.workload)
    if device is None:
        need = int(cell["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            print(f"bench: {need} CUDA device(s) needed, "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                  f"available", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)

    from harness import correct, serve, train
    from harness.records import token_bins
    from reference.weights import dims

    kind = traffic["kind"]
    drivers = {"closed_loop_serve": serve.run, "train": train.run}
    record = drivers[kind](cfg, traffic, args.seed, args.seconds, bool(args.trace), device,
                           T_START)
    bad = forbidden_modules()
    if bad:
        print(f"bench: modules of JAX or of the JAX package are loaded: {bad[:20]}",
              file=sys.stderr)
        return 3

    t_check = time.perf_counter()
    if kind == "train":
        numbers = correct.train_numbers(record, cfg, traffic, args.seed, device)
        attempted = len(record["steps"])
        failed = sum(1 for _, loss, _ in record["steps"] if not math.isfinite(loss))
    else:
        numbers, _ = correct.serve_numbers(record, cfg, args.seed, device)
        t0, t1 = record["t0"], record["t1"]
        live = [r for r in record["requests"] if r["t_submit"] <= t1
                and not (r["times"] and r["state"] == "done" and r["times"][-1] <= t0)]
        attempted = len(live)
        failed = sum(1 for r in live if r["state"] in ("failed", "timeout", "cancelled"))
    check_s = time.perf_counter() - t_check
    gc.collect()
    ok = correct.judge(numbers, limits) and failed == 0

    ctx = {"record": record, "dims": dims(cfg), "traffic": traffic, "config": cfg,
           "cell": cell}
    metrics = {}
    for m in _metrics_of(bench, cell, bool(args.trace)):
        value = _reader(root, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(record["memory_peak_bytes"])}
    if device.type == "cuda":
        dev["power_limit"] = _power_limit()
    result = {"correct": ok, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": dev}
    if args.trace:
        prof = record["profile"]
        dev["busy_s"], dev["window_s"] = prof["busy_s"], prof["window_s"]
        result["breakdown"] = prof["breakdown"]
    result["harness"] = {"setup_s": record["setup_s"], "window_s": record["t1"] - record["t0"],
                         "check_s": check_s}
    if kind != "train":
        # the window's two halves: a rate that differs between them is not settled
        half = (record["t1"] - record["t0"]) / 2
        result["harness"]["tok_per_half"] = token_bins(record, record["t0"], record["t1"], half)
    checks = {k: {"value": numbers.get(k), "limit": lim} for k, lim in limits.items()}
    result["checks"] = checks
    sys.stdout.flush()
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run())
