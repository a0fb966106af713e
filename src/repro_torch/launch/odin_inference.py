"""End-to-end ODIN inference: train CNN1 on synthetic digits, quantize to
8-bit, run held-out inference in every execution mode (fp32 / int8 /
bit-faithful stochastic), and report the accuracy gaps, the images per
second of each mode, and the PCRAM execution cost of one inference.

The paper's core experiment (Table 2 accuracy column + Fig. 6 cost) on the
offline stand-in task: what is validated is the quantization/SC *gap*, not
absolute MNIST numbers.  Runs on the card unless ``--device cpu`` is given:

    PYTHONPATH=src python -m repro_torch.launch.odin_inference [--steps 300] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.odin_linear import OdinConfig
from repro_torch.data.synthetic import digits_batch
from repro_torch.device import resolve_device
from repro_torch.nn.cnn import RUNNABLE_CNN1, cnn_forward, cnn_loss, cnn_param_spec
from repro_torch.nn.module import materialize
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.pim.geometry import OdinModule
from repro_torch.pim.trace import Topology, trace_topology

__all__ = ["MODES", "train_cnn", "eval_batches", "evaluate", "run", "main"]

# (name, config): fp32, the int8 surrogate, hybrid SC at the paper's
# 32-operand row granularity and at a finer popcount boundary, and the
# naive full MUX tree over K (which collapses at K = 784).
MODES: List[Tuple[str, Optional[OdinConfig]]] = [
    ("fp32", None),
    ("int8", OdinConfig(mode="int8", signed_activations=True)),
    ("sc_hybrid32", OdinConfig(mode="sc", signed_activations=False, sc_block_k=32)),
    ("sc_hybrid8", OdinConfig(mode="sc", signed_activations=False, sc_block_k=8)),
    ("sc_full_tree", OdinConfig(mode="sc", signed_activations=True, sc_block_k=0)),
]


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_cnn(topo: Topology, steps: int, batch: int, device: torch.device, seed: int = 0,
              log=print, log_every: int = 50) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """Exact-mode training with plain autograd and AdamW (float32 moments,
    lr 1e-3, no weight decay), as the JAX example trains.  Returns the
    params and the last step's loss and accuracy."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = materialize(cnn_param_spec(topo), gen, device)
    opt_cfg = AdamWConfig(moment_dtype="float32", weight_decay=0.0)
    opt = adamw_init(params, opt_cfg)
    names = list(params)
    metrics = {}
    for i in range(steps):
        b = digits_batch(seed, i, batch=batch, device=device)
        for p in params.values():
            p.requires_grad_(True)
        loss, m = cnn_loss(params, b, topo)
        grads = dict(zip(names, torch.autograd.grad(loss, [params[n] for n in names])))
        params, opt = adamw_update(grads, params, opt, 1e-3, opt_cfg)
        if i % log_every == 0 or i == steps - 1:
            metrics = {"step": i, "loss": m["loss"].item(), "acc": m["acc"].item()}
            log(f"   step {i:4d}  loss {metrics['loss']:.3f}  acc {metrics['acc']:.3f}")
    return params, metrics


def eval_batches(n_batches: int, batch: int, device) -> List[Dict[str, torch.Tensor]]:
    """The held-out batches (seed 1, steps from 10 000), made up front."""
    return [digits_batch(1, 10_000 + i, batch=batch, device=device) for i in range(n_batches)]


@torch.no_grad()
def evaluate(params, topo: Topology, batches, odin: Optional[OdinConfig],
             luts=None) -> Tuple[float, float]:
    """(accuracy, images per second) of one mode over ``batches``; the
    rate is taken after one untimed warm-up forward."""
    device = batches[0]["image"].device
    cnn_forward(params, batches[0]["image"], topo, odin=odin, luts=luts)
    _sync(device)
    t0 = time.perf_counter()
    correct = torch.zeros((), dtype=torch.int64, device=device)
    for b in batches:
        logits = cnn_forward(params, b["image"], topo, odin=odin, luts=luts)
        correct += (logits.argmax(-1) == b["label"]).sum()
    n = sum(int(b["label"].shape[0]) for b in batches)
    acc = int(correct) / n
    _sync(device)
    return acc, n / (time.perf_counter() - t0)


def run(steps: int = 300, batch: int = 64, n_eval: int = 8, eval_batch: int = 64,
        device=None, log=print) -> Dict:
    """Train CNN1, evaluate every mode of :data:`MODES`, trace the PCRAM
    cost.  Returns the params, the eval batches and the results."""
    dev = resolve_device(device)
    topo = RUNNABLE_CNN1
    log(f"== training CNN1 ({steps} steps on synthetic digits, batch {batch}, {dev})")
    t0 = time.perf_counter()
    params, last = train_cnn(topo, steps, batch, dev, log=log)
    _sync(dev)
    train_s = time.perf_counter() - t0
    log(f"   trained in {train_s:.1f}s")

    batches = eval_batches(n_eval, eval_batch, dev)
    log(f"== held-out accuracy per execution mode ({n_eval} x {eval_batch} images)")
    acc, ips = {}, {}
    for name, odin in MODES:
        acc[name], ips[name] = evaluate(params, topo, batches, odin)
        gap = "" if name == "fp32" else f"   (gap {100 * (acc['fp32'] - acc[name]):+.1f} pp)"
        log(f"   {name:13s}: {acc[name]:.3f}   {ips[name]:10.1f} images/s{gap}")

    cost = trace_topology(topo, OdinModule())
    pcram = {"latency_us": cost.total_latency_ns / 1e3, "energy_mj": cost.total_energy_pj / 1e9,
             "macs": cost.total_macs}
    log("== in-situ PCRAM cost for one inference (transaction model, not a measured time)")
    log(f"   latency {pcram['latency_us']:.1f} µs, energy {pcram['energy_mj']:.3f} mJ, "
        f"MACs {pcram['macs'] / 1e3:.0f}k")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"params": params, "batches": batches, "topology": topo,
            "result": {"device": name, "train_steps": steps, "train_s": train_s,
                       "last_train_step": last, "eval_images": n_eval * eval_batch,
                       "accuracy": acc, "images_per_s": ips, "pcram_model": pcram}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--eval-batches", type=int, default=8)
    ap.add_argument("--eval-batch", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)
    out = run(args.steps, args.batch, args.eval_batches, args.eval_batch, args.device)
    print(json.dumps(out["result"]))


if __name__ == "__main__":
    main()
