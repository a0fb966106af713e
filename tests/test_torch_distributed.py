"""The port's distribution layer against the JAX package: the compressed
all-reduce, the data-parallel train step on 4 gloo ranks against the
reference's ``make_dp_train_step`` on a 4-device CPU mesh, the
DTensor-sharded train step on a (4, 2) mesh against one device (phi4,
qwen3-moe's dispatch, hymba's SSM and xlstm's cells, int8 moments on two of
them), the elastic restore onto (2, 2, 2) and the training CLI on 2 ranks.

Each world size runs as one job of ``tests/torch_dist_jobs.py``: a process
per rank on the CPU over gloo, whose rank 0 writes its results for the
assertions here.  The JAX side runs in a subprocess with 4 forced host
devices, as ``tests/test_distributed.py`` runs it.
"""
import dataclasses
import os
import socket
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import compress as jcompress  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import lm, registry  # noqa: E402
from repro_torch.nn.module import materialize  # noqa: E402
from repro_torch.optim.compress import compressed_psum_plain  # noqa: E402
from repro_torch.tree import leaves_with_path, tree_map  # noqa: E402
from torch_dist_jobs import SHARDED_ARCHS  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")
JOBS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_dist_jobs.py")
BASE_LR = 1e-3
B1 = 0.9


def _port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(job, world, d, timeout=300):
    port = _port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, JOBS, job, str(r), str(world), str(port), d],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for r in range(world)]
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"


@pytest.mark.parametrize("n", [1, 255, 256, 1000, 4097])
def test_compressed_psum_bit_for_bit_with_jax(n):
    """The plain version over 4 ranks' gradients equals the reference's
    ``compressed_psum`` under ``jax.vmap(axis_name=)``, on JAX's uniforms
    (every rank draws the same, from the replicated key)."""
    rng = np.random.default_rng(n)
    g = rng.standard_normal((4, 1, n)).astype(np.float32) * np.array([1, 3, 0.5, 2],
                                                                      np.float32)[:, None, None]
    g[2, 0, : min(n, 300)] = 0.0                 # a block whose shared scale is 0 on one rank
    key = jax.random.PRNGKey(n)
    ref = jax.vmap(lambda x: jcompress.compressed_psum(x, "r", key), axis_name="r")(
        jnp.asarray(g))
    u = np.asarray(jax.random.uniform(key, (1, -(-n // 256), 256)))
    got = compressed_psum_plain([torch.from_numpy(x) for x in g], torch.from_numpy(u.copy()))
    for r in range(4):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref[r]))


JAX_DP = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
sys.path.insert(0, SRC)
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import make_mesh
from repro.launch.steps import make_dp_train_step
from repro.models import lm, registry
from repro.optim.adamw import AdamWConfig, adamw_init

cfg = registry.get_smoke("phi4-mini-3.8b")
spec = lm.param_spec(cfg)
flat, tdef = jax.tree_util.tree_flatten_with_path(
    spec, is_leaf=lambda x: hasattr(x, "logical_axes"))
with np.load(os.path.join(D, "params.npz")) as z:
    leaves = [jnp.asarray(z[jax.tree_util.keystr(p)]) for p, _ in flat]
params = jax.tree_util.tree_unflatten(tdef, leaves)
with np.load(os.path.join(D, "batch.npz")) as z:
    batch = {k: jnp.asarray(z[k]) for k in z.files}
key = jax.random.fold_in(jax.random.PRNGKey(1), 0)
keys = jax.random.split(key, len(leaves))
uni = {jax.tree_util.keystr(p): np.asarray(jax.random.uniform(
    k, (1, -(-int(np.prod(s.shape)) // 256), 256))) for (p, s), k in zip(flat, keys)}
np.savez(os.path.join(D, "uniforms.npz"), **uni)
mesh = make_mesh((4,), ("data",))
opt_cfg = AdamWConfig(moment_dtype="float32")
out = {}
for compress in (True, False):
    step = jax.jit(make_dp_train_step(cfg, mesh, opt_cfg, base_lr=BASE_LR, compress=compress))
    p, o, m = step(params, adamw_init(params, opt_cfg), batch, key)
    tag = "c" if compress else "u"
    out[tag + "_loss"] = np.asarray(m["loss"])
    mu = jax.tree.map(lambda d: d["q"], o["mu"],
                      is_leaf=lambda d: isinstance(d, dict) and set(d) == {"q"})
    for name, tree in (("_params", p), ("_mu", mu)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[tag + name + jax.tree_util.keystr(path)] = np.asarray(leaf)
np.savez(os.path.join(D, "jax_dp.npz"), **out)
"""


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """The JAX reference's DP step and the port's on 4 gloo ranks, both
    compressed and not, from the same float32 params, batch and uniforms."""
    d = str(tmp_path_factory.mktemp("dp"))
    cfg = registry.get_smoke("phi4-mini-3.8b")
    spec = tree_map(lambda s: dataclasses.replace(s, dtype=torch.float32), lm.param_spec(cfg))
    params = materialize(spec, torch.Generator().manual_seed(0), "cpu")
    np.savez(os.path.join(d, "params.npz"),
             **{p: t.numpy() for p, _, t in leaves_with_path(params)})
    batch = specs.concrete_batch(cfg, ShapeConfig("t", 32, 8, "train"), 0, 0)
    np.savez(os.path.join(d, "batch.npz"), **{k: v.numpy() for k, v in batch.items()})
    code = f"SRC = {SRC!r}\nD = {d!r}\nBASE_LR = {BASE_LR!r}\n" + textwrap.dedent(JAX_DP)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    _spawn("dp", 4, d)
    with np.load(os.path.join(d, "jax_dp.npz")) as j, np.load(os.path.join(d, "dp.npz")) as t:
        return dict(j), dict(t), params


def _leaf_keys(z, prefix):
    return sorted(k[len(prefix):] for k in z if k.startswith(prefix))


def test_dp_step_uncompressed_matches_jax(dp_runs):
    """pmean of float32 gradients: the reduced gradient (μ = 0.1·g after
    one step) within float32 summation order of the reference's, the loss
    (the ranks' mean) within 1e-6, the params within 1e-6·|p| + 2e-7."""
    j, t, _ = dp_runs
    np.testing.assert_allclose(t["u_loss"], j["u_loss"], rtol=1e-6)
    keys = _leaf_keys(j, "u_mu")
    assert keys == _leaf_keys(t, "u_mu") and len(keys) > 5
    for k in keys:
        ref, got = j["u_mu" + k], t["u_mu" + k]
        assert np.max(np.abs(got - ref)) <= 1e-5 * max(np.max(np.abs(ref)), 1e-30), k
        np.testing.assert_allclose(t["u_params" + k], j["u_params" + k], rtol=1e-6, atol=2e-7)


def test_dp_step_compressed_matches_jax(dp_runs):
    """The compressed step on JAX's uniforms.  The ranks' local gradients
    differ from the reference's by float32 rounding, so a code can move one
    8-bit level where a gradient and its uniform straddle the rounding
    boundary (u ≈ frac(y)); elsewhere the reduced gradients agree to 1e-4
    of a level.  Each such element is reported.  The params after the first
    Adam step (update ≈ sign(g)) then differ by at most 2·lr, lr = 1e-3/100
    at step 0, plus float32 rounding of |p|."""
    j, t, _ = dp_runs
    np.testing.assert_allclose(t["c_loss"], j["c_loss"], rtol=1e-6)
    lr = BASE_LR / 100
    moved = total = 0
    for k in _leaf_keys(j, "c_mu"):
        ref, got = j["c_mu" + k].ravel(), t["c_mu" + k].ravel()
        # one 8-bit level of the reduced gradient, per 256-element block:
        # (1 - b1) · s_max / 4, s_max ≥ every rank's block max / 127
        level = (1 - B1) * t["c_smax" + k].ravel() / 4
        lv = np.repeat(level, 256)[: ref.size]
        diff = np.abs(got - ref)
        whole = np.rint(diff / np.maximum(lv, 1e-30))
        assert np.all(whole <= 4), (k, whole.max())
        assert np.all(np.abs(diff - whole * lv) <= 1e-4 * lv + 1e-6 * np.abs(ref)), k
        moved += int(np.count_nonzero(whole))
        total += ref.size
        p_ref, p_got = j["c_params" + k], t["c_params" + k]
        assert np.all(np.abs(p_got - p_ref) <= 2 * lr * (1 + 1e-5) + 1e-6 * np.abs(p_ref)), k
    assert moved <= 1e-3 * total, (moved, total)
    if moved:
        warnings.warn(f"{moved} of {total} reduced-gradient elements moved one 8-bit level "
                      "against the reference (gradient and uniform at a rounding boundary)")


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """One 8-rank run of the ``sharded`` job: phi4's results and those of
    the archs of ``torch_dist_jobs.SHARDED_ARCHS``."""
    d = str(tmp_path_factory.mktemp("sharded"))
    _spawn("sharded", 8, d)
    with np.load(os.path.join(d, "sharded.npz")) as z, \
            np.load(os.path.join(d, "sharded_more.npz")) as more:
        return dict(z), dict(more)


def test_sharded_train_step_matches_one_device(sharded_runs):
    """The DTensor-sharded train step on a (4, 2) mesh (float32 params by
    ``param_pspecs``, float32 moments by ``optimizer_pspecs``, the batch on
    ``data``, ``grad_shardings`` pinned, inside ``logical_sharding``)
    against the same step on one device: the loss within 1e-6 (the
    reference's own test allows 2e-3) and every param within 1e-7 + 1e-6·|p|
    (one Adam step moves a param by ≈ lr = 3e-6; the sharded sums only
    reorder float32 additions), the placements kept; and the elastic restore
    of an unsharded checkpoint onto (2, 2, 2), each rank's shard exact."""
    z, _ = sharded_runs
    assert bool(z["kept"])
    np.testing.assert_allclose(z["got_loss"], z["ref_loss"], rtol=1e-6)
    keys = _leaf_keys(z, "ref")
    assert keys == _leaf_keys(z, "got") and len(keys) > 5
    for k in keys:
        np.testing.assert_allclose(z["got" + k], z["ref" + k], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("arch", sorted(SHARDED_ARCHS))
def test_sharded_train_step_more_archs(sharded_runs, arch):
    """The same step for qwen3-moe (float32 moments; the MoE dispatch on
    DTensors replicates the expert ids and ranks them in the reference's
    global order, so every ``dispatch_indices`` call equals one device's
    bit for bit), hymba (the SSM's per-rank scan) and xlstm (the per-rank
    mLSTM and sLSTM recurrences), both with int8 moments on sharded leaves.
    The loss within 1e-6; float32 moments within 3e-6 of each leaf's
    largest (worst 7.7e-7) and params within 1e-7 + 1e-6·|p|.  int8
    moments: codes within one level, scales within 2e-5 of each leaf's
    largest (worst 4.9e-6): a code sits at a rounding edge where the two
    runs' float32 sums part; params within 2·lr + 1e-6·|p|, the elements
    past 1e-7 + 1e-6·|p| (a gradient within float32 noise of 0 turned the
    other way by Adam's first step) reported, at most 1e-4 of them."""
    _, z = sharded_runs
    get = lambda k: z[f"{arch}['{k}']"]
    assert bool(get("kept"))
    np.testing.assert_allclose(get("got_loss"), get("ref_loss"), rtol=1e-6)
    if arch.startswith("qwen3"):
        assert int(get("dispatches")) > 0 and bool(get("dispatch_equal"))
    keys = _leaf_keys(z, f"{arch}['ref']")
    assert keys == _leaf_keys(z, f"{arch}['got']") and len(keys) > 5
    lr = 3e-4 / 100
    parted = total = 0
    for k in keys:
        ref, got = z[f"{arch}['ref']{k}"], z[f"{arch}['got']{k}"]
        if SHARDED_ARCHS[arch] == "float32":
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7, err_msg=k)
        else:
            assert np.all(np.abs(got - ref) <= 2 * lr * (1 + 1e-5) + 1e-6 * np.abs(ref)), k
            parted += int(np.count_nonzero(np.abs(got - ref) > 1e-7 + 1e-6 * np.abs(ref)))
        total += ref.size
    assert parted <= 1e-4 * total, (parted, total)
    if parted:
        warnings.warn(f"{arch}: {parted} of {total} params parted at Adam's first step "
                      "(a gradient within float32 noise of 0)")
    for k in _leaf_keys(z, f"{arch}['ref_opt']"):
        ref, got = z[f"{arch}['ref_opt']{k}"], z[f"{arch}['got_opt']{k}"]
        if ref.dtype == np.int8:
            assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1, k
        else:
            tol = 2e-5 if k.endswith("['s']") else 3e-6
            assert np.abs(got - ref).max() <= tol * max(np.abs(ref).max(), 1e-30), k


def test_cli_two_ranks_grad_compress_learns(tmp_path):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train --mesh 2
    --grad-compress``: the loss falls over 20 steps, rank 0 alone writes the
    checkpoint."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
           "--master-port", str(_port()), "-m", "repro_torch.launch.train",
           "--arch", "phi4-mini-3.8b", "--smoke", "--mesh", "2", "--grad-compress",
           "--device", "cpu", "--steps", "20", "--batch", "8", "--seq", "64",
           "--lr", "1e-2", "--ckpt-dir", str(tmp_path / "ck"), "--save-every", "100"]
    r = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    losses = [float(line.split("loss")[1].split()[0]) for line in r.stdout.splitlines()
              if line.startswith("[train] step")]
    assert len(losses) == 3 and losses[-1] < losses[0], losses
    assert os.listdir(tmp_path / "ck") == ["step_000000020"]


def test_cli_mesh_must_match_world_size(monkeypatch):
    from repro_torch.launch import train

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        train.main(["--arch", "phi4-mini-3.8b", "--smoke", "--mesh", "4", "--grad-compress",
                    "--device", "cpu", "--steps", "1"])
