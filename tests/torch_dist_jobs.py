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


# the archs of job_sharded beyond phi4 (float32 moments), with their moment
# dtypes: MoE dispatch, Hymba's ring and SSM, xLSTM's cells
SHARDED_ARCHS = {"qwen3-moe-235b-a22b": "float32", "hymba-1.5b": "int8", "xlstm-350m": "int8"}


def _train_pair(cfg, opt_cfg, mesh, rules, batch):
    """One train step of ``cfg`` on one device and the same step sharded
    on ``mesh`` (params by ``param_pspecs``, moments by
    ``optimizer_pspecs``, the batch on ``data``, ``grad_shardings``
    pinned, inside ``logical_sharding``), from the same float32 params.
    Returns (one-device params, moments, metrics, the sharded step's
    gathered params, moments, metrics, whether every leaf kept its
    placements, each run's MoE dispatches)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.mesh import param_pspecs
    from repro_torch.launch.steps import make_train_step, optimizer_pspecs
    from repro_torch.nn import moe
    from repro_torch.nn.module import P, materialize, placements
    from repro_torch.nn.pcontext import logical_sharding
    from repro_torch.optim.adamw import adamw_init

    spec = _f32_spec(cfg)
    params = materialize(spec, torch.Generator().manual_seed(0), "cpu")
    dispatch, runs = moe.dispatch_indices, []

    def recorded(expert_ids, n_experts, capacity):
        out = dispatch(expert_ids, n_experts, capacity)
        runs[-1].append(tuple(t.clone() for t in out))
        return out

    moe.dispatch_indices = recorded
    try:
        runs.append([])
        ref_p = tree_map(torch.clone, params)
        ref_p, ref_o, ref_m = make_train_step(cfg, opt_cfg)(ref_p, adamw_init(ref_p, opt_cfg),
                                                            batch)
        pps = param_pspecs(spec, rules, mesh)
        place = lambda t, ps: distribute_tensor(t, mesh, placements(ps, mesh),
                                                src_data_rank=None)
        sp = tree_map(place, params, pps)
        so = tree_map(place, adamw_init(params, opt_cfg), optimizer_pspecs(pps, opt_cfg))
        sb = {k: place(v, P(("data",))) for k, v in batch.items()}
        grad_sh = tree_map(lambda ps: placements(ps, mesh), pps, is_leaf=lambda x: isinstance(x, P))
        runs.append([])
        with logical_sharding(mesh, rules):
            sp, so, sm = make_train_step(cfg, opt_cfg, grad_shardings=grad_sh)(sp, so, sb)
    finally:
        moe.dispatch_indices = dispatch
    kept = all(ok for _, _, ok in leaves_with_path(
        tree_map(lambda t, pl: tuple(t.placements) == tuple(pl), sp, grad_sh)))
    whole = lambda t: t.full_tensor()
    return (ref_p, ref_o, ref_m, tree_map(whole, sp), tree_map(whole, so), sm, kept,
            runs[0], runs[1])


def job_sharded(rank, world, d):
    """The DTensor-sharded train step on a (4, 2) mesh against one device —
    phi4 with float32 moments, then ``SHARDED_ARCHS`` — and an elastic
    restore onto (2, 2, 2)."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh, sharding_rules
    from repro_torch.models import registry
    from repro_torch.nn.module import P, placements
    from repro_torch.optim.adamw import AdamWConfig

    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    rules = sharding_rules(mesh, "train")
    shape = ShapeConfig("t", 32, 8, "train")
    cfg = registry.get_smoke("phi4-mini-3.8b")
    ref_p, _, ref_m, full, _, sm, kept, _, _ = _train_pair(
        cfg, AdamWConfig(moment_dtype="float32"), mesh, rules,
        specs.concrete_batch(cfg, shape, 0, 0))
    more = {}
    for arch, moments in SHARDED_ARCHS.items():
        cfg = registry.get_smoke(arch)
        rp, ro, rm, gp, go, gm, k, rd, gd = _train_pair(
            cfg, AdamWConfig(moment_dtype=moments), mesh, rules,
            specs.concrete_batch(cfg, shape, 0, 0))
        more[arch] = {"ref": rp, "got": gp, "ref_opt": ro, "got_opt": go,
                      "ref_loss": rm["loss"], "got_loss": gm["loss"],
                      "kept": torch.tensor(k), "dispatches": torch.tensor(len(rd)),
                      "dispatch_equal": torch.tensor(len(rd) == len(gd) and all(
                          torch.equal(a, b) for x, y in zip(rd, gd) for a, b in zip(x, y)))}

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
        _save(os.path.join(d, "sharded_more.npz"), **more)


# the sharded static loop of job_decode: smoke configs in float32, a batch
# of 4 prompts of 6 tokens, 4 decode steps into caches of 16 rows — on the
# (2, 2) mesh each rank holds 2 slots and 8 rows (hymba's ring: 4 of 8), so
# the prefill fills model rank 0's rows, the first decode steps see model
# rank 1's rows all invisible and the last ones write them
DECODE_ARCHS = ("phi4-mini-3.8b", "deepseek-v3-671b", "hymba-1.5b", "xlstm-350m")
DECODE = {"batch": 4, "prompt": 6, "gen": 4, "max_len": 16}
# ``sdpa`` past its blockwise threshold: q [4, 48, 4, 8], k/v [4, 48, 2, 8],
# threshold 16 rows, chunk 4; per window, the sharded path's output
LONG_SDPA = {"shape": (4, 48, 4, 2, 8), "threshold": 16, "chunk": 4, "windows": (0, 12)}


def long_sdpa_inputs():
    """q, k, v of ``LONG_SDPA`` from a seeded generator (alike on every
    rank and in the test)."""
    B, S, H, Hkv, D = LONG_SDPA["shape"]
    g = torch.Generator().manual_seed(0)
    return (torch.randn(B, S, H, D, generator=g), torch.randn(B, S, Hkv, D, generator=g),
            torch.randn(B, S, Hkv, D, generator=g))


def _f32_spec(cfg):
    from repro_torch.models import lm

    return tree_map(lambda s: s.__class__(s.shape, s.logical_axes, torch.float32, s.init,
                                          s.scale), lm.param_spec(cfg))


def job_decode(rank, world, d):
    """The sharded prefill and decode steps of ``DECODE_ARCHS`` on a (2, 2)
    mesh, caches placed by ``cache_pspecs`` (batch on ``data``, rows on
    ``model``): rank 0 writes every arch's gathered logits, tokens and
    caches, and ``LONG_SDPA``'s sharded attention."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import static_loop
    from repro_torch.models import registry
    from repro_torch.nn.attention import sdpa
    from repro_torch.nn.module import abstract

    whole = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    out = {}
    for arch in DECODE_ARCHS:
        cfg = registry.get_smoke(arch).with_overrides(kv_dtype="float32")
        params = _load_tree(os.path.join(d, f"{arch}.npz"), abstract(_f32_spec(cfg), "cpu"))
        with np.load(os.path.join(d, "prompts.npz")) as z:
            prompts = torch.from_numpy(z[arch])
        last, seen, toks, caches = static_loop(cfg, params, prompts, DECODE["gen"],
                                               DECODE["max_len"], mesh)
        out[arch] = {"prefill": last, "decode": seen, "tokens": toks,
                     "caches": tree_map(whole, caches)}
    q, k, v = (distribute_tensor(t, mesh, (Shard(0), Shard(2))) for t in long_sdpa_inputs())
    pos = torch.arange(q.shape[1])
    out["long_sdpa"] = {f"w{w}": sdpa(q, k, v, pos, pos, w, LONG_SDPA["chunk"],
                                      LONG_SDPA["threshold"]).full_tensor()
                        for w in LONG_SDPA["windows"]}
    if rank == 0:
        _save(os.path.join(d, "decode.npz"), **out)


if __name__ == "__main__":
    job, rank, world, port, d = sys.argv[1], *map(int, sys.argv[2:5]), sys.argv[5]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        {"dp": job_dp, "sharded": job_sharded, "decode": job_decode}[job](rank, world, d)
        dist.barrier()
    finally:
        dist.destroy_process_group()
