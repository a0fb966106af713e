"""Training loop and CLI with checkpoint-restart fault tolerance, on one device.

The port of the JAX package's ``launch/train.py`` (its single-device path):

* ``--resume`` picks up the latest complete checkpoint (saves are atomic: a
  crash mid-save never corrupts the run) and replays the exact data stream
  (the pipeline is indexed by the step saved in the checkpoint).
* watchdog: a step longer than ``--step-deadline`` seconds checkpoints and
  exits with code 75 (temporary failure), so that a supervisor relaunches
  the run with ``--resume``.
* ``--max-wall``: graceful preemption — checkpoint and exit 75.
* ``--simulate-crash-at``: kills the process at that step without a
  checkpoint (failure injection for tests).
* ``--mesh N`` (or ``4x2``, axes data,model) with ``--grad-compress``: pure
  data parallelism over every rank of the mesh, each gradient leaf through
  the int8 stochastic-rounded compressed all-reduce
  (``optim/compress.py``).  The ranks come from ``RANK``/``WORLD_SIZE`` as
  ``torchrun`` sets them; a mesh whose size is not the world size raises.
  The group is NCCL on the card and gloo with ``--device cpu``; each rank
  trains on its rows of the global batch and rank 0 alone writes
  checkpoints.  ``--mesh`` without ``--grad-compress`` builds the mesh and
  nothing uses it, as in the reference.

Parameters are drawn by ``materialize`` from a ``torch.Generator`` seeded by
``--seed`` on the device.  The run is on the card unless ``--device`` names
another device (``--device cpu`` runs the plain PyTorch path); without a
card the default raises.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m --smoke \\
      --steps 50 --batch 8 --seq 128 --ckpt-dir build/run1 --resume
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch phi4-mini-3.8b --smoke --mesh 2 --grad-compress --device cpu
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_dp_train_step, make_train_step
from repro_torch.models import lm, registry
from repro_torch.nn.module import materialize
from repro_torch.optim.adamw import AdamWConfig, adamw_init

__all__ = ["build_state", "train_loop", "main"]


def build_state(cfg, generator: torch.Generator, opt_cfg: AdamWConfig, device):
    """{params, opt, data_step}: params drawn from ``generator`` on ``device``."""
    params = materialize(lm.param_spec(cfg), generator, device)
    return {"params": params, "opt": adamw_init(params, opt_cfg),
            "data_step": torch.zeros((), dtype=torch.int32, device=device)}


def train_loop(cfg, *, steps: int, batch: int, seq: int, ckpt_dir: str,
               resume: bool = False, accum: int = 1, seed: int = 0,
               save_every: int = 20, keep: int = 3,
               opt_cfg: AdamWConfig = AdamWConfig(moment_dtype="float32"),
               step_deadline: float = 0.0, max_wall: float = 0.0,
               simulate_crash_at: int = -1, log_every: int = 10,
               base_lr: float = 3e-4, warmup: int = 0, device=None,
               grad_compress: bool = False, mesh=None):
    """Returns (final_state, losses).  Exits 75 on watchdog/preemption.

    With ``grad_compress`` the step is ``make_dp_train_step`` over ``mesh``
    (a ``DeviceMesh`` on an initialised process group, which the caller
    owns): this rank trains on its rows of the global batch, the rounding
    draws come from a generator seeded by (seed + 1, step) alike on every
    rank, and only rank 0 of the mesh logs and writes checkpoints."""
    dev = resolve_device(device)
    state = build_state(cfg, torch.Generator(device=dev).manual_seed(seed), opt_cfg, dev)
    start_step = 0
    if resume:
        last = ckpt.latest_step(ckpt_dir)
        if last is not None:
            state, start_step = ckpt.restore(ckpt_dir, last, state)
            print(f"[train] resumed from step {start_step}")

    shape = ShapeConfig("train", seq, batch, "train")
    warmup = warmup or max(5, steps // 10)
    rows, writer = slice(None), True
    if grad_compress:
        if mesh is None:
            raise ValueError("--grad-compress needs a device mesh")
        if accum != 1:
            raise ValueError("the data-parallel step takes no gradient accumulation")
        ranks = mesh.mesh.flatten().tolist()
        r, n = ranks.index(mesh.get_rank()), len(ranks)
        if batch % n:
            raise ValueError(f"batch {batch} does not split over {n} ranks")
        rows, writer = slice(r * batch // n, (r + 1) * batch // n), r == 0
        step_fn = make_dp_train_step(cfg, mesh, opt_cfg, base_lr=base_lr, compress=True)
    else:
        step_fn = make_train_step(cfg, opt_cfg, accum=accum, base_lr=base_lr, warmup=warmup)

    losses = []
    t_start = time.time()
    for step in range(start_step, steps):
        b = specs.concrete_batch(cfg, shape, seed, int(state["data_step"]), accum=accum,
                                 device=dev)
        t0 = time.time()
        if grad_compress:
            gen = torch.Generator(device=dev).manual_seed((seed + 1) * 2**32 + step)
            p, o, metrics = step_fn(state["params"], state["opt"],
                                    {k: v[rows] for k, v in b.items()}, generator=gen)
        else:
            p, o, metrics = step_fn(state["params"], state["opt"], b)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        state = {"params": p, "opt": o, "data_step": state["data_step"] + 1}
        losses.append(loss)
        if writer and (step % log_every == 0 or step == steps - 1):
            print(f"[train] step {step:5d}  loss {loss:.6f}  {dt * 1e3:.0f} ms", flush=True)

        if simulate_crash_at == step:
            print("[train] simulated crash (no checkpoint)!", flush=True)
            os._exit(137)

        deadline_hit = step_deadline and dt > step_deadline
        wall_hit = max_wall and (time.time() - t_start) > max_wall
        if writer and ((step + 1) % save_every == 0 or step == steps - 1
                       or deadline_hit or wall_hit):
            ckpt.save(ckpt_dir, step + 1, state, keep=keep)
        if deadline_hit:
            print(f"[train] watchdog: step took {dt:.1f}s > {step_deadline}s — "
                  "checkpointed, exiting 75 for relaunch", flush=True)
            sys.exit(75)
        if wall_hit:
            print("[train] wall-clock preemption — checkpointed, exiting 75", flush=True)
            sys.exit(75)
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="build/repro_train")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--mesh", default="", help="e.g. 4 or 4x2 (axes data,model)")
    ap.add_argument("--int8-moments", action="store_true")
    ap.add_argument("--step-deadline", type=float, default=0.0)
    ap.add_argument("--max-wall", type=float, default=0.0)
    ap.add_argument("--simulate-crash-at", type=int, default=-1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)

    cfg = registry.get_smoke(args.arch) if args.smoke else registry.get_config(args.arch)
    opt_cfg = AdamWConfig(moment_dtype="int8" if args.int8_moments else "float32")
    device, mesh = args.device, None
    if args.mesh:
        device, mesh = _init_mesh(args.mesh, args.device)
    try:
        train_loop(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                   ckpt_dir=args.ckpt_dir, resume=args.resume, accum=args.accum,
                   seed=args.seed, save_every=args.save_every, opt_cfg=opt_cfg,
                   step_deadline=args.step_deadline, max_wall=args.max_wall,
                   simulate_crash_at=args.simulate_crash_at, base_lr=args.lr,
                   device=device, grad_compress=args.grad_compress, mesh=mesh)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


def _init_mesh(spec: str, device):
    """(this rank's device, the mesh): the process group from ``RANK`` and
    ``WORLD_SIZE`` (and ``MASTER_ADDR``/``MASTER_PORT``), NCCL on the card
    and gloo on the CPU, and a ``spec`` mesh over all of it."""
    import torch.distributed as dist

    dims = tuple(int(x) for x in spec.split("x"))
    names = ("data", "model")[: len(dims)] if len(dims) <= 2 else ("pod", "data", "model")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    n = 1
    for d in dims:
        n *= d
    if n != world:
        raise ValueError(f"--mesh {spec} needs {n} ranks, WORLD_SIZE is {world} "
                         f"(launch with torchrun --nproc-per-node {n})")
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    os.environ.setdefault("MASTER_ADDR", "localhost")
    os.environ.setdefault("MASTER_PORT", "29500")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", rank=rank,
                            world_size=world)
    return dev, make_mesh(dims, names, dev.type)


if __name__ == "__main__":
    main()
