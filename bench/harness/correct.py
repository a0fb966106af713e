"""What decides ``correct``: the program's outputs against the plain
reference, each number held to its limit in ``bench/limits/<cell>.json``.

Serving: the reference runs once over each sampled request's prompt and
served tokens; the numbers are the widest gap by which a served token's
reference logit lies below the reference's best at its position, and the
mean of those gaps over the sampled tokens.

Training: the reference follows the program's first steps from the same
weights and batches; the numbers are the largest loss gap, and by the
worst leaf the gap between the program's and the reference's norms of
the first gradient (from the optimizer's state after step 1) and of the
change after the last checked step, each against the reference's norm of
that leaf or of the median leaf, whichever is larger.  Leaves whose
reference gradient is under a thousandth of the median leaf's are left
out of the change.

The reference runs after the program's state is freed, with the weights
made again from the seed, float32 products in full float32.
"""
from __future__ import annotations

import gc
import math
import statistics
from typing import Dict, Optional, Tuple

import torch

from reference.model import no_tf32, served_gaps
from reference.train import train_steps
from reference.weights import dims, make_weights

__all__ = ["gap_numbers", "serve_gaps", "serve_numbers", "train_numbers", "train_reference", "compare_train", "judge"]


def serve_gaps(record: Dict, cfg: Dict, seed: int, device,
               control: Optional[str] = None) -> Tuple[list, list]:
    """Every sampled served token's gap (program) and, with ``control``, the
    gap of the token the control puts first at the same positions."""
    _release(device)
    m = dims(cfg)
    w = make_weights(cfg, seed, device)
    prog, low = [], []
    with no_tf32():
        for s in record["check_sample"]:
            g = served_gaps(w, m, torch.as_tensor(s["prompt"], device=device),
                            torch.as_tensor(s["served"], device=device), control)
            prog += g["program"]
            low += g.get("control", [])
    del w
    return prog, low


def serve_numbers(record: Dict, cfg: Dict, seed: int, device,
                  control: Optional[str] = None) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(program's numbers, control's numbers or {})."""
    prog, low = serve_gaps(record, cfg, seed, device, control)
    return gap_numbers(prog), gap_numbers(low)


def gap_numbers(gaps) -> Dict[str, float]:
    """The widest gap and the mean gap over the sampled served tokens."""
    if not gaps:
        return {}
    return {"logit_gap": max(gaps), "logit_gap_mean": sum(gaps) / len(gaps)}


def _release(device) -> None:
    """Hand the device memory the program's freed state left cached back,
    so that the reference's weights find one free stretch."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _worst_leaf(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> float:
    names = [n for n in ref if keep is None or n in keep]
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names)


def compare_train(prog: Dict, ref: Dict) -> Dict[str, float]:
    med = statistics.median(ref["grad_norms"].values())
    moving = {n for n, g in ref["grad_norms"].items() if g >= 1e-3 * med}
    return {
        "loss_gap": max(abs(a - b) for a, b in zip(prog["losses"], ref["losses"])),
        "grad_norm_gap": _worst_leaf(prog["grad_norms"], ref["grad_norms"]),
        "change_norm_gap": _worst_leaf(prog["change_norms"], ref["change_norms"], moving),
    }


def train_reference(cfg: Dict, traffic: Dict, seed: int, device, prec: str = "fp32",
                    rows: Optional[int] = None) -> Dict:
    """The reference's readings of the checked steps from the seed's weights
    and batches; ``prec="fp8"`` is the control, ``rows`` keeps only the
    first rows of every batch (the fault of half a batch left out)."""
    from harness.train import batch

    _release(device)
    V = dims(cfg)["V"]
    n = int(traffic["check_steps"])
    batches = [(b["tokens"][:rows], b["labels"][:rows])
               for b in (batch(traffic, V, seed, i, device) for i in range(n))]
    w = make_weights(cfg, seed, device)
    with no_tf32():
        ref = train_steps(w, cfg, batches, float(traffic["base_lr"]), int(traffic["warmup"]),
                          remake=lambda: make_weights(cfg, seed, device), prec=prec)
    del w, batches
    return ref


def train_numbers(record: Dict, cfg: Dict, traffic: Dict, seed: int, device
                  ) -> Dict[str, float]:
    """The numbers of the program's checked steps against the reference."""
    return compare_train(record["check"], train_reference(cfg, traffic, seed, device))


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every limited number present, finite and within its limit."""
    return bool(limits) and all(
        k in numbers and math.isfinite(numbers[k]) and numbers[k] <= lim
        for k, lim in limits.items())
