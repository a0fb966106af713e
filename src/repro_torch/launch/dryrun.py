"""Dry-run: trace every (arch × shape) cell on the production mesh at full
size and record its memory, FLOPs, bytes, collectives and roofline, the
port of the JAX package's ``launch/dryrun.py``.

Where the reference lowers and compiles a cell for 256 or 512 placeholder
devices, the port runs the cell's step once on a fake process group of the
mesh's size (``torch.testing``'s ``FakeStore``: collectives return at once)
with DTensor params, optimizer state and batch placed by the pspec trees
over meta-device shards: nothing is allocated, every op runs its shape
logic, and the collectives DTensor inserts are the ones a real run takes.
The step is the one the reference lowers — ``make_train_step`` with
``grad_shardings``, ``make_prefill_step`` or ``make_decode_step`` — inside
``logical_sharding``, under ``hlo.CostCounter`` (one rank's FLOPs, bytes,
collective payloads and live memory) and ``CommDebugMode``.

Per cell this records into ``<out>/<cell>.json`` the reference's keys:
  * per-rank memory: argument bytes (the local shards of every input),
    output and alias bytes (AdamW updates in place: a train step's outputs
    are its inputs), temp bytes (the peak of what the step allocated,
    outputs excluded),
  * FLOPs and bytes accessed per rank (``launch/hlo.py``),
  * collective payload bytes by type,
  * MODEL_FLOPS = 6·N_active·D (2· for inference) and the useful-FLOPs
    ratio, and the three-term roofline on the H100 model of ``hlo.HW``.
A cell that fails to trace is recorded ``LOWER_FAILED`` with its error, and
``main`` exits nonzero.  Nothing here initialises a process group or sets
an environment variable at import.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-405b --shape train_4k
  python -m repro_torch.launch.dryrun --all --multi-pod both --out build/dryrun
  python -m repro_torch.launch.dryrun --all --multi-pod both --jobs 6   # 6 processes
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.configs.base import LM_SHAPES
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.hlo import HW, CostCounter, collective_bytes, roofline_terms
from repro_torch.launch.mesh import make_production_mesh, param_pspecs, sharding_rules
from repro_torch.launch.steps import (make_decode_step, make_prefill_step, make_train_step,
                                      optimizer_pspecs)
from repro_torch.models import lm, registry
from repro_torch.nn import module as nnmod
from repro_torch.nn.module import P, axis_sizes, placements
from repro_torch.nn.pcontext import logical_sharding
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.tree import leaves_with_path, tree_map

__all__ = ["lower_cell", "run_cell", "step_costs", "cell_id", "fake_group", "main"]

_is_p = lambda x: isinstance(x, P)


class fake_group:
    """A fake default process group of ``world`` ranks for the block (this
    process is rank 0); the identity when a group is already initialised."""

    def __init__(self, world: int):
        self.world, self.own = world, False

    def __enter__(self):
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore

        if not dist.is_initialized():
            dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=self.world)
            self.own = True
        return self

    def __exit__(self, *exc):
        if self.own:
            import torch.distributed as dist

            dist.destroy_process_group()
        return False


def _fake(shape, dtype, mesh, spec):
    """A DTensor of global ``shape`` placed by ``spec`` on ``mesh``, its
    local shard on the meta device."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape = torch.Size(shape)
    pl = placements(spec, mesh)
    local, _ = compute_local_shape_and_global_offset(shape, mesh, pl)
    return DTensor.from_local(torch.empty(local, dtype=dtype, device="meta"), mesh, pl,
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _place(tree, pspecs, mesh):
    return tree_map(lambda t, ps: _fake(t.shape, t.dtype, mesh, ps), tree, pspecs)


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor leaf (a storage once)."""
    seen, n = set(), 0
    for _, _, t in leaves_with_path(tree):
        if not isinstance(t, torch.Tensor):
            continue
        t = t.to_local() if hasattr(t, "to_local") else t
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            n += t.untyped_storage().nbytes()
    return n


def _storages(tree):
    out = set()
    for _, _, t in leaves_with_path(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if hasattr(t, "to_local") else t
            out.add(t.untyped_storage()._cdata)
    return out


def _ax(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= axis_sizes(mesh)[a]
    return n


def _train_cell(cfg, shape, mesh, rules, accum, opt_cfg, accum_dtype, p_ps, params=None,
                device="meta", seed=0):
    """(step, (params, opt, batch)) of a sharded train cell: DTensors placed
    by the pspec trees, over meta shards, or over real tensors on
    ``device`` (params drawn from ``seed``, the batch from the pipeline)."""
    from torch.distributed.tensor import distribute_tensor

    spec_tree = lm.param_spec(cfg)
    o_ps = optimizer_pspecs(p_ps, opt_cfg)
    b_ps = specs_mod.batch_pspecs(cfg, shape, mesh, accum)
    if device == "meta":
        if params is None:
            params = tree_map(lambda s, ps: _fake(s.shape, s.dtype, mesh, ps), spec_tree, p_ps)
        opt = _place(adamw_init(nnmod.abstract(spec_tree), opt_cfg), o_ps, mesh)
        batch = _place(specs_mod._train_specs(cfg, shape, accum), b_ps, mesh)
    else:
        put = lambda t, ps: distribute_tensor(t, mesh, placements(ps, mesh), src_data_rank=None)
        plain = nnmod.materialize(spec_tree, torch.Generator(device=device).manual_seed(seed),
                                  device)
        params = tree_map(put, plain, p_ps)
        opt = tree_map(put, adamw_init(plain, opt_cfg), o_ps)
        batch = tree_map(put, specs_mod.concrete_batch(cfg, shape, seed, 0, accum, device),
                         b_ps)
    grad_sh = tree_map(lambda ps: placements(ps, mesh), p_ps, is_leaf=_is_p)
    step = make_train_step(cfg, opt_cfg, accum=accum, grad_shardings=grad_sh,
                           accum_dtype=accum_dtype)
    return step, (params, opt, batch)


def step_costs(cfg, shape, mesh, *, device="meta", accum: int = 1,
               opt_cfg: AdamWConfig = AdamWConfig(), seed: int = 0):
    """One sharded train step of ``cfg`` at ``shape`` on ``mesh`` (a
    ``DeviceMesh`` on an initialised group) under the counter, on meta
    shards or on real tensors on ``device``.  Returns (``ModuleCosts``,
    seconds of the step, its metrics); a card is synchronized around the
    step."""
    rules = sharding_rules(mesh, "train")
    p_ps = param_pspecs(lm.param_spec(cfg), rules, mesh)
    step, inputs = _train_cell(cfg, shape, mesh, rules, accum, opt_cfg, torch.float32, p_ps,
                               device=device, seed=seed)
    from torch.distributed.tensor.experimental import implicit_replication

    counter = CostCounter()
    counter.exclude(inputs)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with counter, logical_sharding(mesh, rules), implicit_replication():
        _, _, metrics = step(*inputs)
    if cuda:
        torch.cuda.synchronize()
    return counter.costs(), time.perf_counter() - t0, metrics


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False, mesh=None,
               smoke: bool = False, accum: Optional[int] = None,
               odin_mode: Optional[str] = None, remat: Optional[str] = None,
               kv_dtype: Optional[str] = None, rules: Optional[Dict] = None,
               device_type: Optional[str] = None):
    """Build one cell on the default process group (the caller's, of the
    mesh's size).  Returns ``(run, inputs, meta)``: ``run()`` executes the
    cell's step once on ``inputs``, DTensors over meta shards."""
    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod,
                                                              device_type=device_type)
    info = specs_mod.input_specs(arch, shape_name, smoke=smoke, accum=accum,
                                 kv_dtype=kv_dtype)
    cfg, shape = info["cfg"], info["shape"]
    if odin_mode is not None:
        cfg = cfg.with_overrides(odin_mode=odin_mode)
    if remat is not None:
        cfg = cfg.with_overrides(remat=remat)
    kind = info["kind"]
    rules = rules if rules is not None else sharding_rules(mesh, kind)

    spec_tree = lm.param_spec(cfg)
    p_ps = param_pspecs(spec_tree, rules, mesh)
    params = tree_map(lambda s, ps: _fake(s.shape, s.dtype, mesh, ps), spec_tree, p_ps)
    meta = {
        "arch": arch, "shape": shape_name, "kind": kind,
        "mesh": axis_sizes(mesh), "accum": info["accum"],
        "params": nnmod.count_params(spec_tree),
        "smoke": smoke, "odin_mode": cfg.odin_mode, "remat": cfg.remat,
        "kv_dtype": cfg.kv_dtype,
    }
    fsdp = ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)

    if kind == "train":
        opt_cfg = AdamWConfig()
        acc_dt = (getattr(torch, specs_mod.DRYRUN_ACCUM_DTYPE.get(arch, "float32"))
                  if not smoke else torch.float32)
        step, inputs = _train_cell(cfg, shape, mesh, rules, info["accum"], opt_cfg, acc_dt,
                                   p_ps, params=params)
        meta["accum_dtype"] = str(acc_dt).replace("torch.", "")
        meta["model_flops"] = lm.model_flops(cfg, shape.global_batch * shape.seq_len,
                                             train=True)
    elif kind == "prefill":
        batch = _place(info["batch"], specs_mod.batch_pspecs(cfg, shape, mesh, 1), mesh)
        step = make_prefill_step(cfg, max_len=shape.seq_len)
        inputs = (params, batch)
        meta["model_flops"] = lm.model_flops(cfg, shape.global_batch * shape.seq_len,
                                             train=False)
    else:  # decode
        caches = _place(info["caches"], specs_mod.cache_pspecs(cfg, info["caches"], mesh),
                        mesh)
        B = shape.global_batch
        tok = info["tokens"]
        tok_ps = P(fsdp if B % _ax(mesh, fsdp) == 0 else None, *([None] * (tok.dim() - 1)))
        tokens = _fake(tok.shape, tok.dtype, mesh, tok_ps)
        step = make_decode_step(cfg)
        inputs = (params, caches, tokens)
        meta["model_flops"] = lm.model_flops(cfg, B, train=False)

    def run():
        from torch.distributed.tensor.experimental import implicit_replication

        with logical_sharding(mesh, rules), implicit_replication():
            return step(*inputs)

    return run, inputs, meta


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False, mesh=None,
             smoke: bool = False, accum: Optional[int] = None,
             odin_mode: Optional[str] = None, remat: Optional[str] = None,
             kv_dtype: Optional[str] = None, rules: Optional[Dict] = None,
             hw: HW = HW(), device_type: Optional[str] = None) -> Dict:
    """Trace + analyze one cell; returns the JSON-able record.  Without a
    ``mesh`` the production mesh is built on a fake group of its size (the
    caller's group when one is initialised)."""
    from torch.distributed.tensor.debug import CommDebugMode

    world = mesh.size() if mesh is not None else (512 if multi_pod else 256)
    t0 = time.time()
    try:
        with fake_group(world):
            run, inputs, meta = lower_cell(
                arch, shape_name, multi_pod=multi_pod, mesh=mesh, smoke=smoke,
                accum=accum, odin_mode=odin_mode, remat=remat, kv_dtype=kv_dtype,
                rules=rules, device_type=device_type)
            counter = CostCounter()
            counter.exclude(inputs)
            with CommDebugMode() as comm, counter:
                outputs = run()
            costs = counter.costs()
            arg_bytes = _local_bytes(inputs)
            in_st = _storages(inputs)
            out_bytes = _local_bytes(outputs)
            alias_bytes = sum(_local_bytes(t) for _, _, t in leaves_with_path(outputs)
                              if isinstance(t, torch.Tensor)
                              and (_storages(t) & in_st))
            n_comm = comm.get_total_counts()
            del outputs
    except Exception as e:  # a failure to trace is a bug — record it loudly
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "LOWER_FAILED", "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:]}
    t1 = time.time()

    mem = {
        "argument_bytes": arg_bytes,
        "output_bytes": out_bytes,
        # the peak of what the step allocated, less its new outputs
        "temp_bytes": max(0.0, costs.peak_live_bytes - (out_bytes - alias_bytes)),
        "alias_bytes": alias_bytes,
        "code_bytes": 0,
    }
    mem["total_bytes"] = (mem["argument_bytes"] + mem["output_bytes"]
                          + mem["temp_bytes"] - mem["alias_bytes"])
    cost = {"flops": costs.flops, "bytes_accessed": costs.memory_bytes,
            "n_ops": costs.n_ops, "n_collectives": costs.n_collectives,
            "comm_debug_collectives": n_comm,
            "n_whiles": costs.n_whiles, "n_unknown_trip": costs.n_unknown_trip}
    coll = collective_bytes(costs)

    n_dev = 1
    for v in meta["mesh"].values():
        n_dev *= v
    terms = roofline_terms(costs.flops, costs.memory_bytes, costs.collective_wire, hw)
    model_flops_per_dev = meta["model_flops"] / n_dev
    terms["useful_flops_ratio"] = (
        model_flops_per_dev / costs.flops if costs.flops > 0 else -1.0)
    terms["mfu_upper_bound"] = (
        model_flops_per_dev / hw.peak_flops / terms["step_time_lb_s"]
        if terms["step_time_lb_s"] > 0 else -1.0)
    return {**meta, "multi_pod": multi_pod, "status": "OK",
            "lower_s": round(t1 - t0, 2), "compile_s": 0.0,
            "n_devices": n_dev, "memory": mem, "cost": cost,
            "collectives": coll, "roofline": terms,
            "fits_hbm": mem["total_bytes"] <= hw.hbm_bytes}


def cell_id(arch: str, shape: str, multi_pod: bool) -> str:
    return f"{arch}__{shape}__{'pod2' if multi_pod else 'pod1'}"


def _summary(cid: str, rec: Dict) -> str:
    if rec["status"] != "OK":
        return f"FAIL {cid}: {rec['error'].splitlines()[0][:300]}"
    r = rec["roofline"]
    return (f"{rec['status']:4} {cid}: trace {rec['lower_s']}s  "
            f"mem {rec['memory']['total_bytes']/1e9:.2f} GB/dev "
            f"(fits={rec['fits_hbm']})  bottleneck={r['bottleneck']} "
            f"[c={r['compute_s']:.2e} m={r['memory_s']:.2e} x={r['collective_s']:.2e}]s")


def _trace_to(job) -> tuple:
    """One cell ``(cid, path, arch, shape, multi_pod, smoke, device_type)``
    traced and its record written to ``path``, in this process or in a
    worker of ``--jobs`` (its own process, hence its own fake group);
    returns ``(cid, path)``."""
    cid, path, arch, shape, multi_pod, smoke, device_type = job
    print(f"trace   {cid}", flush=True)
    rec = run_cell(arch, shape, multi_pod=multi_pod, smoke=smoke, device_type=device_type)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return cid, path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, choices=registry.ARCH_IDS + [None])
    ap.add_argument("--shape", default=None, choices=list(LM_SHAPES) + [None])
    ap.add_argument("--all", action="store_true", help="every runnable cell")
    ap.add_argument("--multi-pod", dest="mp", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    ap.add_argument("--device", default=None,
                    help="device type of the mesh (default: cuda where a card is "
                         "present, else cpu; the shards are meta tensors either "
                         "way, so any host runs every cell)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="trace the cells in this many processes at once")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s.name) for a, s in registry.cells()]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        reason = registry.skip_reason(args.arch, args.shape)
        if reason:
            print(f"SKIP {args.arch} × {args.shape}: {reason}")
            return
        cells = [(args.arch, args.shape)]

    pods = {"single": [False], "multi": [True], "both": [False, True]}[args.mp]
    os.makedirs(args.out, exist_ok=True)
    todo = []
    for arch, shape in cells:
        for mp in pods:
            cid = cell_id(arch, shape, mp)
            path = os.path.join(args.out, cid + ".json")
            if os.path.exists(path) and not args.force:
                print(f"cached  {cid}")
                continue
            todo.append((cid, path, arch, shape, mp))
    failures, t0 = 0, time.time()
    jobs = [(*job, args.smoke, args.device) for job in todo]
    if args.jobs > 1:
        import multiprocessing
        import signal

        # a terminated run takes its workers with it (the pool's exit
        # terminates them)
        signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
        pool = multiprocessing.get_context("spawn").Pool(args.jobs)
    else:
        pool = contextlib.nullcontext()
    with pool:
        traced = pool.imap_unordered(_trace_to, jobs) if args.jobs > 1 else map(_trace_to, jobs)
        for cid, path in traced:
            with open(path) as f:
                rec = json.load(f)
            failures += rec["status"] != "OK"
            print(_summary(cid, rec), flush=True)
    print(f"{len(todo)} cell(s) in {time.time() - t0:.1f} s over {args.jobs} process(es)",
          flush=True)
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


if __name__ == "__main__":
    main()
