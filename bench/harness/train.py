"""The training driver: ``repro_torch.launch.steps.make_train_step``,
back to back, on batches made on the device from the seed.

Set-up builds one object — the parameters, the AdamW state and the step
— and drives it through its first ``check_steps`` steps, reading what the
reference compares: each step's loss, the first gradient of every leaf
as the optimizer's state holds it after step 1, and every leaf's change
after the last of them.  The window then runs the same object on, whole
steps, each ending in the loss's readback.
"""
from __future__ import annotations

import gc
import time
from typing import Dict

import torch

from harness import port
from harness.profile import DeviceProfile
from reference.train import dequantize, leaves
from reference.weights import dims, make_weights
from repro_torch.launch.steps import make_train_step
from repro_torch.optim.adamw import AdamWConfig, adamw_init

__all__ = ["run", "batch"]


def batch(traffic: Dict, vocab: int, seed: int, i: int, device) -> Dict[str, torch.Tensor]:
    """Step ``i``'s batch: ``batch`` rows of ``seq + 1`` random token ids,
    the tokens and their next-token labels."""
    B, S = int(traffic["batch"]), int(traffic["seq"])
    gen = torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + i) % (1 << 63))
    seq = torch.randint(0, vocab, (B, S + 1), generator=gen, device=device)
    return {"tokens": seq[:, :-1].to(torch.int32).contiguous(),
            "labels": seq[:, 1:].to(torch.int32).contiguous()}


def _grad_norms(opt: Dict, cfg: Dict, b1: float) -> Dict[str, float]:
    """Each leaf's first gradient from the moments after one step."""
    L = dims(cfg)["L"]
    mu = port.flat_leaves(opt["mu"])
    out = {}
    for name, st in mu.items():
        stacked = name not in ("embed", "lm_head", "final_norm")
        parts = range(L) if stacked else [None]
        for l in parts:
            sl = (lambda a: a[l]) if stacked else (lambda a: a)
            m = (sl(st["q"]).float() if "s" not in st
                 else dequantize(sl(st["q"]), sl(st["s"]), "m"))
            out[name if l is None else f"{name}.{l}"] = float(m.norm()) / (1.0 - b1)
    return out


def run(cfg: Dict, traffic: Dict, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float) -> Dict:
    m = dims(cfg)
    mcfg = port.model_config(cfg, remat=traffic.get("remat", "none"))
    w = make_weights(cfg, seed, device)
    params = port.param_tree(w, mcfg)
    opt_cfg = AdamWConfig(moment_dtype=traffic.get("moments", "int8"))
    opt = adamw_init(params, opt_cfg)
    step_fn = make_train_step(mcfg, opt_cfg, base_lr=float(traffic["base_lr"]),
                              warmup=int(traffic["warmup"]))
    state = {"params": params, "opt": opt}

    def one(i: int) -> float:
        with torch.profiler.record_function("bench.train_step"):
            state["params"], state["opt"], met = step_fn(
                state["params"], state["opt"], batch(traffic, m["V"], seed, i, device))
        return float(met["loss"])

    n_check = int(traffic["check_steps"])
    check = {"losses": []}
    for i in range(n_check):
        check["losses"].append(one(i))
        if i == 0:
            check["grad_norms"] = _grad_norms(state["opt"], cfg, opt_cfg.b1)
    start = dict((n, t) for n, t, _ in leaves(make_weights(cfg, seed, device), cfg))
    check["change_norms"] = {n: float((t.float() - start[n].float()).norm())
                             for n, t, _ in leaves(w, cfg)}
    del start
    prof = DeviceProfile(device) if trace else None
    if prof is not None:
        prof.warm()
    profile_s = float(traffic.get("profile_seconds", 6.0))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    profiling = False
    steps = []
    i = n_check
    while time.perf_counter() - t0 < seconds:
        if prof is not None and not profiling and time.perf_counter() - t0 >= seconds - profile_s:
            prof.start()
            profiling = True
        loss = one(i)
        steps.append((time.perf_counter(), loss, profiling))
        i += 1
    t1 = time.perf_counter()
    if prof is not None and not profiling:
        # a window shorter than its last step: trace one step past it
        prof.start()
        profiling = True
        one(i)
    if profiling:
        prof.stop()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    record = {"kind": "train", "t0": t0, "t1": t1, "setup_s": setup_s,
              "memory_peak_bytes": peak, "steps": steps,
              "tokens_per_step": int(traffic["batch"]) * int(traffic["seq"]),
              "check": check}
    if trace:
        record["profile"] = prof.reduce()
        record["profile"]["t0"], record["profile"]["t1"] = prof.t0, prof.t1
    del state, params, opt, w, step_fn
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return record
