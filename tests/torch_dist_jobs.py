"""Multi-rank jobs of ``tests/test_torch_distributed.py``: one process per
rank on the CPU over a gloo group, run as

    python tests/torch_dist_jobs.py <job> <rank> <world> <port> <dir>

Each job reads its inputs from ``<dir>`` and writes rank 0's results there
as ``<job>.npz`` (the test holds them against the JAX package); a check a
job makes on its own raises, and the process exits nonzero.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.tree import leaves_with_path, tree_map  # noqa: E402

torch.set_num_threads(1)


def _load_tree(path, like):
    """An npz keyed by tree paths → a tensor tree shaped like ``like``."""
    with np.load(path) as z:
        return _fill(like, {k: z[k] for k in z.files})


def _fill(like, flat):
    it = iter(torch.from_numpy(np.array(flat[p])) for p, _, _ in leaves_with_path(like))
    return tree_map(lambda _: next(it), like)


def _save(path, **trees):
    out = {}
    for name, tree in trees.items():
        if isinstance(tree, torch.Tensor):
            out[name] = tree.detach().cpu().numpy()
            continue
        if isinstance(tree, dict) and all(k.startswith("[") for k in tree):
            out.update({name + p: t.detach().cpu().numpy() for p, t in tree.items()})
            continue
        for p, _, t in leaves_with_path(tree):
            out[name + p] = t.detach().cpu().numpy()
    np.savez(path, **out)


def job_dp(rank, world, d):
    """The data-parallel step, compressed and not, on the JAX package's
    params, batch and uniforms; and ``compressed_psum`` over the ranks
    against its plain version."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import loss_and_grads, make_dp_train_step
    from repro_torch.models import lm, registry
    from repro_torch.nn.module import abstract
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.optim.compress import (compress_int8, compressed_psum,
                                            compressed_psum_plain)

    # compressed_psum on 3 leaf shapes: every rank's gradients drawn alike,
    # the plain version of all of them is the yardstick, bit for bit
    from repro_torch.optim import compress

    for n, piece in ((1, 1 << 16), (300, 1 << 16), (4097, 1 << 16), (4097, 3)):
        compress.PIECE_BLOCKS = piece          # 4097 elements in 6 pieces of ≤ 3 blocks
        g = torch.Generator().manual_seed(n)
        gs = [torch.randn(1, n, generator=g) * (1 + r) for r in range(world)]
        gs[1][0, :7] = 0.0
        u = torch.rand(1, -(-n // 256), 256, generator=g)
        got = compressed_psum(gs[rank].clone(), None, uniforms=u)
        want = compressed_psum_plain(gs, u)
        assert torch.equal(got, want), (n, (got - want).abs().max())
        # drawing from a generator: the draws of draw_uniforms, alike on every rank
        got = compressed_psum(gs[rank].clone(), None, torch.Generator().manual_seed(7))
        u = compress.draw_uniforms(gs[0].shape, torch.Generator().manual_seed(7), "cpu")
        assert torch.equal(got, compressed_psum_plain(gs, u)), n
    compress.PIECE_BLOCKS = 1 << 16

    cfg = registry.get_smoke("phi4-mini-3.8b")
    spec = tree_map(lambda s: s.__class__(s.shape, s.logical_axes, torch.float32, s.init,
                                          s.scale), lm.param_spec(cfg))
    like = abstract(spec, "cpu")
    mesh = make_mesh((world,), ("data",), "cpu")
    opt_cfg = AdamWConfig(moment_dtype="float32")
    with np.load(os.path.join(d, "batch.npz")) as z:
        batch = {k: torch.from_numpy(z[k]) for k in z.files}
    rows = batch["tokens"].shape[0] // world
    local = {k: v[rank * rows:(rank + 1) * rows] for k, v in batch.items()}
    uni = _load_tree(os.path.join(d, "uniforms.npz"), like)
    out = {}

    def shared_scale(g, u):
        s = compress_int8(g.float().reshape(1, -1), uniforms=u)[1]
        dist.all_reduce(s, op=dist.ReduceOp.MAX)
        return s

    _, _, g0 = loss_and_grads(_load_tree(os.path.join(d, "params.npz"), like), local, cfg)
    out["c_smax"] = tree_map(shared_scale, g0, uni)
    for compress in (True, False):
        params = _load_tree(os.path.join(d, "params.npz"), like)
        opt = adamw_init(params, opt_cfg)
        step = make_dp_train_step(cfg, mesh, opt_cfg, base_lr=1e-3, compress=compress)
        p, o, m = step(params, opt, local, uniforms=uni if compress else None)
        tag = "c" if compress else "u"
        out[f"{tag}_params"], out[f"{tag}_loss"] = p, m["loss"]
        # float32 moments: every leaf of the tree is a {"q": value}
        out[f"{tag}_mu"] = {p[:-len("['q']")]: t for p, _, t in leaves_with_path(o["mu"])}
    if rank == 0:
        _save(os.path.join(d, "dp.npz"), **out)


def job_sharded(rank, world, d):
    """The DTensor-sharded train step on a (4, 2) mesh against one device,
    and an elastic restore onto (2, 2, 2)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh, param_pspecs, sharding_rules
    from repro_torch.launch.steps import make_train_step, optimizer_pspecs
    from repro_torch.models import lm, registry
    from repro_torch.nn.module import P, materialize, placements
    from repro_torch.nn.pcontext import logical_sharding
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    cfg = registry.get_smoke("phi4-mini-3.8b")
    opt_cfg = AdamWConfig(moment_dtype="float32")
    spec = tree_map(lambda s: s.__class__(s.shape, s.logical_axes, torch.float32, s.init,
                                          s.scale), lm.param_spec(cfg))
    params = materialize(spec, torch.Generator().manual_seed(0), "cpu")
    batch = specs.concrete_batch(cfg, ShapeConfig("t", 32, 8, "train"), 0, 0)
    step = make_train_step(cfg, opt_cfg)
    ref_p = tree_map(torch.clone, params)
    ref_p, _, ref_m = step(ref_p, adamw_init(ref_p, opt_cfg), batch)

    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    rules = sharding_rules(mesh, "train")
    pps = param_pspecs(spec, rules, mesh)
    is_p = lambda x: isinstance(x, P)
    place = lambda t, ps: distribute_tensor(t, mesh, placements(ps, mesh), src_data_rank=None)
    sp = tree_map(place, params, pps)
    so = tree_map(place, adamw_init(params, opt_cfg), optimizer_pspecs(pps, opt_cfg))
    sb = {k: place(v, P(("data",))) for k, v in batch.items()}
    grad_sh = tree_map(lambda ps: placements(ps, mesh), pps, is_leaf=is_p)
    sstep = make_train_step(cfg, opt_cfg, grad_shardings=grad_sh)
    with logical_sharding(mesh, rules):
        sp, so, sm = sstep(sp, so, sb)
    full = tree_map(lambda t: t.full_tensor(), sp)
    kept = all(ok for _, _, ok in leaves_with_path(
        tree_map(lambda t, pl: tuple(t.placements) == tuple(pl), sp, grad_sh)))

    # elastic restore: an unsharded checkpoint placed onto a (2, 2, 2) mesh
    tree = {"w": torch.arange(64.0).reshape(8, 8), "step": torch.tensor(5, dtype=torch.int32)}
    ck = os.path.join(d, "ck")
    if rank == 0:
        ckpt.save(ck, 5, tree)
    dist.barrier()
    mesh3 = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    pl = {"w": placements(P(("pod", "data"), "model"), mesh3), "step": placements(P(), mesh3)}
    out, s = ckpt.restore(ck, 5, tree, placements=pl, mesh=mesh3)
    assert s == 5 and tuple(out["w"].placements) == tuple(pl["w"])
    assert torch.equal(out["w"].full_tensor(), tree["w"])
    r = mesh3.get_coordinate()
    want = tree["w"][(2 * r[0] + r[1]) * 2:(2 * r[0] + r[1] + 1) * 2, r[2] * 4:(r[2] + 1) * 4]
    assert torch.equal(out["w"].to_local(), want), (r, out["w"].to_local())
    assert int(out["step"].to_local()) == 5
    if rank == 0:
        _save(os.path.join(d, "sharded.npz"), ref=ref_p, got=full,
              ref_loss=ref_m["loss"], got_loss=sm["loss"],
              kept=torch.tensor(kept))


if __name__ == "__main__":
    job, rank, world, port, d = sys.argv[1], *map(int, sys.argv[2:5]), sys.argv[5]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        {"dp": job_dp, "sharded": job_sharded}[job](rank, world, d)
        dist.barrier()
    finally:
        dist.destroy_process_group()
