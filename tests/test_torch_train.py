"""The port's training path against the JAX package's: ``lr_schedule``,
``_xent``, ``loss_fn`` (DeepSeek's MTP loss, MusicGen's codebooks, Qwen2-VL's
extras), the gradients of every smoke arch, one ``make_train_step`` at
accum 1 and 2 with float32 and int8 moments, the MoE gradient through a
dispatch that drops, and ``chunked_scan``'s checkpointed gradient; then the
port alone: remat ``none``/``full``/``dots`` agree and really rematerialise,
and the in-place AdamW equals the functional one bit for bit.

Weights are drawn in float32 by the port's init rules and carried to the JAX
package as numpy (``repro_torch.bridge``); batches come from the port's
``concrete_batch`` (numpy), fed to both.  Tolerances, float32 throughout:
losses within 1e-5 relative (measured ≤ 2e-7: the two frameworks sum the
log-sum-exp and the means in different orders); gradients within 2e-5 of
the leaf's largest magnitude (normwise; measured ≤ 2e-6).
"""
import dataclasses
import math
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.models import registry as jregistry
from repro.nn import moe as jmoe
from repro.nn.scan_utils import chunked_scan as jax_chunked_scan
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro_torch.bridge import params_from_numpy, tree_to_numpy
from repro_torch.configs.base import MoEConfig, ShapeConfig
from repro_torch.launch import steps as tsteps
from repro_torch.launch.specs import concrete_batch
from repro_torch.models import lm as tlm
from repro_torch.models import registry as tregistry
from repro_torch.nn import moe as tmoe
from repro_torch.nn import scan_utils
from repro_torch.nn.module import materialize as port_materialize
from repro_torch.optim import adamw as tadamw
from repro_torch.tree import leaves_with_path, tree_map

LOSS_RTOL = 1e-5
GRAD_TOL = 2e-5
SHAPE = ShapeConfig("train", 16, 2, "train")


def _float32_params(cfg, seed=0):
    """float32 weights for the port's ``cfg`` by its init rules (a seeded
    ``torch.Generator``) as a numpy tree, which the JAX package takes as
    its param tree (the same dicts, lists and stacked leaves)."""
    spec = tree_map(lambda s: dataclasses.replace(s, dtype=torch.float32), tlm.param_spec(cfg))
    return tree_to_numpy(port_materialize(spec, torch.Generator().manual_seed(seed), "cpu"))


def _jax_params(cfg):
    return jax.tree.map(jnp.asarray, _float32_params(cfg))


def _port_tree(jax_tree):
    return params_from_numpy(jax.tree.map(np.asarray, jax_tree), "cpu")


def _jax_batch(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


def _assert_grads_close(port, ref, tol=GRAD_TOL):
    """Every leaf: max |port - ref| ≤ tol · max |ref| (exactly equal when the
    reference leaf is all 0: a leaf the loss does not read)."""
    for (path, _, g), (_, _, r) in zip(leaves_with_path(port), leaves_with_path(ref)):
        assert g.shape == r.shape and g.dtype == r.dtype, path
        scale = r.abs().max().item()
        err = (g - r).abs().max().item()
        assert err <= tol * scale, (path, err, scale)


@pytest.fixture(scope="module")
def smoke_grads():
    """Per smoke arch: (port (loss, metrics, grads), JAX (loss, metrics,
    grads) as port tensors), on one float32 batch of 2 x 16 tokens."""
    out = {}
    for arch in tregistry.ARCH_IDS:
        jcfg, tcfg = jregistry.get_smoke(arch), tregistry.get_smoke(arch)
        jp = _jax_params(tcfg)
        batch = concrete_batch(tcfg, SHAPE, 0, 3)
        fn = jax.jit(jax.value_and_grad(lambda p, b, c=jcfg: jlm.loss_fn(p, b, c),
                                        has_aux=True))
        (jl, jm), jg = fn(jp, _jax_batch(batch))
        ref = (float(jl), {k: float(v) for k, v in jm.items()}, _port_tree(jg))
        out[arch] = (tsteps.loss_and_grads(_port_tree(jp), batch, tcfg), ref)
    return out


@pytest.mark.parametrize("arch", tregistry.ARCH_IDS)
def test_grads_match_jax(smoke_grads, arch):
    (loss, metrics, grads), (jl, jm, jg) = smoke_grads[arch]
    assert math.isclose(loss.item(), jl, rel_tol=LOSS_RTOL)
    _assert_grads_close(grads, jg)
    # every leaf the loss reads gets a nonzero gradient; deepseek's
    # route_bias only steers selection and gets exact zeros, as in JAX
    zero = [p for p, _, g in leaves_with_path(grads) if not g.any()]
    assert zero == (["['segments'][1]['moe']['route_bias']"]
                    if arch == "deepseek-v3-671b" else [])


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "musicgen-medium", "qwen2-vl-2b"])
def test_loss_fn_metrics_match_jax(smoke_grads, arch):
    """DeepSeek's mtp_loss (labels[:, 2:], weight 0.1) and loss_total, the
    codebooks' swapped labels and the vision extras: every metric."""
    (_, metrics, _), (_, jm, _) = smoke_grads[arch]
    assert sorted(metrics) == sorted(jm)
    for k, v in jm.items():
        assert math.isclose(metrics[k].item(), v, rel_tol=LOSS_RTOL), (k, metrics[k], v)
    if arch == "deepseek-v3-671b":
        assert math.isclose(jm["loss_total"], jm["loss"] + 0.1 * jm["mtp_loss"],
                            rel_tol=1e-6)


def test_xent_matches_jax():
    """Values and gradients of ``_xent`` on logits far from 0 (the detached
    max matters) over a [2, 3, 4] batch of labels at V = 1000."""
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 3, 4, 1000)) * 8 + 50).astype(np.float32)
    labels = rng.integers(0, 1000, (2, 3, 4)).astype(np.int32)
    ref, ref_g = jax.value_and_grad(lambda z: jlm._xent(z, jnp.asarray(labels), 1000).sum())(
        jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_(True)
    out = tlm._xent(z, torch.from_numpy(labels), 1000)
    out.sum().backward()
    np.testing.assert_allclose(out.sum().item(), float(ref), rtol=1e-6)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(ref_g), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("base,warmup,total", [(3e-4, 100, 10_000), (1e-3, 5, 50),
                                               (2e-3, 1, 7)])
def test_lr_schedule_matches_jax(base, warmup, total):
    """Through warmup, the cosine and past ``total`` (float32; XLA's and
    PyTorch's float32 cosines may part by an ulp: rtol 1e-6)."""
    steps = np.unique(np.r_[np.arange(0, 3 * warmup + 3), [total - 1, total, total + 9]])
    for s in steps:
        ref = float(jsteps.lr_schedule(jnp.int32(s), base, warmup, total))
        got = tsteps.lr_schedule(torch.tensor(s, dtype=torch.int32), base, warmup, total)
        assert got.dtype == torch.float32
        assert math.isclose(got.item(), ref, rel_tol=1e-6), (s, got, ref)


TRAIN_ARCH = "phi4-mini-3.8b"
STEP_SHAPE = ShapeConfig("train", 16, 4, "train")


def _report_first_step_partings(new_p, ref_p, g_port, g_ref, lr, what):
    """New params, port against JAX.  Adam's first step moves each element by
    lr·g/(|g| + eps) ≈ lr·sign(g): a gradient within the gradient tolerance
    of 0 may come out with the other sign, or below eps, in one package, and
    its element then parts by up to 2·lr.  Such elements are reported (a
    warning naming each leaf, how many parted and how many of those by the
    sign), never absorbed by the tolerance: every element beyond 1e-6 +
    1e-5·|ref| must be one whose two gradients lie within the gradient
    tolerance of 0."""
    parted = {}
    for (path, _, p), (_, _, r), (_, _, g), (_, _, gr) in zip(
            leaves_with_path(new_p), leaves_with_path(ref_p), leaves_with_path(g_port),
            leaves_with_path(g_ref)):
        bad = (p - r).abs() > 1e-6 + 1e-5 * r.abs()
        if not bad.any():
            continue
        gtol = GRAD_TOL * gr.abs().max().item()
        tiny = (g.abs() <= gtol) & (gr.abs() <= gtol)
        assert not (bad & ~tiny).any(), (what, path, (p - r)[bad & ~tiny][:5])
        parted[path] = (int(bad.sum()), int((bad & (torch.sign(g) != torch.sign(gr))).sum()))
    if parted:
        warnings.warn(f"{what}: elements parted at Adam's first step where both gradients "
                      f"are within the tolerance of 0 (lr = {lr:.3e}; leaf: (parted, of "
                      f"them by the sign)): {parted}")
    return parted


@pytest.fixture(scope="module")
def train_step_runs():
    """The JAX ``make_train_step`` (jitted) and the port's, one step from the
    same weights and zero moments, for accum 1 and 2 and both moment
    dtypes; the step's gradients from each package's loss gradient at the
    same weights (accum 1)."""
    jcfg, tcfg = jregistry.get_smoke(TRAIN_ARCH), tregistry.get_smoke(TRAIN_ARCH)
    jp = _jax_params(tcfg)
    out = {}
    for accum in (1, 2):
        batch = concrete_batch(tcfg, STEP_SHAPE, 0, 5, accum=accum)
        for moments in ("float32", "int8"):
            jopt_cfg = JaxAdamWConfig(moment_dtype=moments)
            jstep = jax.jit(jsteps.make_train_step(jcfg, jopt_cfg, accum=accum, base_lr=1e-3,
                                                   warmup=3))
            jnew, jopt, jmet = jstep(jp, jax_adamw_init(jp, jopt_cfg), _jax_batch(batch))
            tp = _port_tree(jp)
            topt_cfg = tadamw.AdamWConfig(moment_dtype=moments)
            tstep = tsteps.make_train_step(tcfg, topt_cfg, accum=accum, base_lr=1e-3, warmup=3)
            tnew, topt, tmet = tstep(tp, tadamw.adamw_init(tp, topt_cfg), batch)
            out[accum, moments] = ((tnew, topt, tmet),
                                   (_port_tree(jnew), _port_tree(jopt),
                                    {k: float(v) for k, v in jmet.items()}))
    flat = concrete_batch(tcfg, STEP_SHAPE, 0, 5)
    jg = jax.grad(lambda p: jlm.loss_fn(p, _jax_batch(flat), jcfg)[0])(jp)
    out["grads"] = (tsteps.loss_and_grads(_port_tree(jp), flat, tcfg)[2], _port_tree(jg))
    return out


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_train_step_matches_jax(train_step_runs, accum, moments):
    (tnew, topt, tmet), (jnew, jopt, jmet) = train_step_runs[accum, moments]
    assert sorted(tmet) == sorted(jmet) == ["grad_norm", "loss", "lr"]
    for k in ("loss", "grad_norm", "lr"):
        assert math.isclose(tmet[k].item(), jmet[k], rel_tol=LOSS_RTOL), (k, tmet[k], jmet[k])
    assert int(topt["step"]) == int(jopt["step"]) == 1
    g_port, g_ref = train_step_runs["grads"]
    if accum == 1:
        _assert_grads_close(g_port, g_ref)
    _report_first_step_partings(tnew, jnew, g_port, g_ref, jmet["lr"], f"accum {accum}, {moments}")
    if moments == "float32":
        # m = 0.1·g and v = 0.05·g² after one step: the gradients' tolerance
        _assert_grads_close(topt["mu"], jopt["mu"])
        _assert_grads_close(topt["nu"], jopt["nu"], tol=2 * GRAD_TOL)
        return
    # int8: per-block scales (a block's max over 127) within the gradients'
    # tolerance; the codes may part by one level where the float32 moment
    # sits at a rounding edge (round-to-nearest for m, ceil of √v / scale)
    for tree_p, tree_r in ((topt["mu"], jopt["mu"]), (topt["nu"], jopt["nu"])):
        for (path, name, a), (_, _, b) in zip(leaves_with_path(tree_p),
                                              leaves_with_path(tree_r)):
            assert a.dtype == b.dtype, path
            if name == "s":
                assert ((a - b).abs() <= 2 * GRAD_TOL * b.abs().max()).all(), path
            else:
                levels = (a.int() - b.int()).abs()
                assert levels.max() <= 1, path
                assert levels.float().mean() < 0.01, (path, levels.float().mean())


def test_moe_grad_through_dropping_dispatch():
    """``tests/test_moe.py:91`` held by values: the gradient of Σ moe_block² for
    the weights and the input at capacity factor 2.0 (as there) and 0.5,
    where assignments drop; a dropped assignment's sentinel row gets no
    gradient (float32, atol 1e-5 as ``tests/test_torch_moe.py``)."""
    d = 8
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, d)).astype(np.float32)
    for cf in (2.0, 0.5):
        kw = dict(n_experts=4, top_k=2, d_ff=16, capacity_factor=cf)
        jcfg, tcfg = JaxMoEConfig(**kw), MoEConfig(**kw)
        spec = tree_map(lambda s: dataclasses.replace(s, dtype=torch.float32),
                        tmoe.moe_spec(tcfg, d))
        jp = jax.tree.map(jnp.asarray, tree_to_numpy(
            port_materialize(spec, torch.Generator().manual_seed(0), "cpu")))
        jg = jax.jit(jax.grad(lambda p, x: (jmoe.moe_block(p, x, jcfg) ** 2).sum(),
                              argnums=(0, 1)))(jp, jnp.asarray(x))
        tp = _port_tree(jp)
        for t in tp.values():
            t.requires_grad_(True)
        tx = torch.from_numpy(x).requires_grad_(True)
        (tmoe.moe_block(tp, tx, tcfg) ** 2).sum().backward()
        for k, g in jg[0].items():
            # route_bias only steers selection: no gradient reaches it
            got = tp[k].grad if tp[k].grad is not None else torch.zeros_like(tp[k])
            np.testing.assert_allclose(got.numpy(), np.asarray(g), atol=1e-5, err_msg=k)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[1]), atol=1e-5)
        # the dispatch of this input: capacity 12 keeps all 24 assignments,
        # capacity 3 drops some (the case the gradient must route around)
        with torch.no_grad():
            probs = torch.softmax(torch.from_numpy(x).reshape(12, d) @ tp["router"], -1)
            ids = tmoe.top_k_lowest_first(probs, 2).reshape(-1).to(torch.int32)
            _, keep = tmoe.dispatch_indices(ids, 4, max(1, int(12 * 2 * cf / 4)))
        assert bool(keep.all()) == (cf == 2.0)


def test_chunked_scan_checkpointed_grad_matches_jax():
    """``tests/test_recurrent.py:40``: S = 37 in chunks of 8, the JAX
    ``chunked_scan``'s gradient (rtol 1e-5).  Under autograd the 4 whole
    chunks run again in the backward (32 more steps) and the 5-step tail
    does not; without autograd nothing is recomputed."""
    xs = np.random.default_rng(0).standard_normal((37, 4)).astype(np.float32)

    def jstep(c, x):
        c = jnp.tanh(0.8 * c + x)
        return c, c.sum()

    g_ref = jax.grad(lambda xs: jax_chunked_scan(jstep, jnp.zeros(4), xs, chunk=8)[1].sum())(
        jnp.asarray(xs))
    calls = []

    def step(c, x):
        calls.append(1)
        c = torch.tanh(0.8 * c + x[0])
        return c, c.sum()

    t = torch.from_numpy(xs).requires_grad_(True)
    _, ys = scan_utils.chunked_scan(step, torch.zeros(4), [t], chunk=8)
    ys.sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(g_ref), rtol=1e-5)
    assert len(calls) == 37 + 32
    calls.clear()
    with torch.no_grad():
        scan_utils.chunked_scan(step, torch.zeros(4), [t], chunk=8)
    assert len(calls) == 37


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "deepseek-v3-671b", "hymba-1.5b",
                                  "xlstm-350m", "qwen2-vl-2b"])
def test_remat_modes_equal_and_rematerialise(arch, monkeypatch):
    """``remat`` none / full / dots: the same loss and gradients bit for bit;
    full and dots run each layer's forward again in the backward, none does
    not; without autograd (serving) no mode runs a layer twice."""
    cfg = tregistry.get_smoke(arch)
    spec = tree_map(lambda s: dataclasses.replace(s, dtype=torch.float32), tlm.param_spec(cfg))
    params = port_materialize(spec, torch.Generator().manual_seed(0), "cpu")
    batch = concrete_batch(cfg, SHAPE, 0, 0)
    calls = []
    block_apply = tlm.block_apply
    monkeypatch.setattr(tlm, "block_apply",
                        lambda *a, **k: calls.append(1) or block_apply(*a, **k))
    out = {}
    for remat in ("none", "full", "dots"):
        c = cfg.with_overrides(remat=remat)
        calls.clear()
        loss, _, grads = tsteps.loss_and_grads(params, batch, c)
        out[remat] = (loss, grads, len(calls))
        calls.clear()
        with torch.no_grad():
            tlm.forward(params, batch["tokens"], c, patch_embeds=batch.get("patch_embeds"),
                        pos3d=batch.get("pos3d"))
        assert len(calls) == cfg.n_layers
    extra = 1 if cfg.mtp else 0                 # the MTP head's block, never rematerialised
    assert out["none"][2] == cfg.n_layers + extra
    for remat in ("full", "dots"):
        assert out[remat][2] == 2 * cfg.n_layers + extra
        assert torch.equal(out[remat][0], out["none"][0])
        for (path, _, a), (_, _, b) in zip(leaves_with_path(out[remat][1]),
                                           leaves_with_path(out["none"][1])):
            assert torch.equal(a, b), (remat, path)


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_inplace_adamw_equals_functional(moments, monkeypatch):
    """``adamw_update_`` writes ``adamw_update``'s values bit for bit: the
    hymba smoke config's bf16 and float32 leaves (1-D, 2-D, stacked 3-D),
    three steps of random gradients, blocks of 1000 elements so that leaves
    are cut into several blocks (and a row longer than a block is one)."""
    monkeypatch.setattr(tadamw, "BLOCK_ELEMS", 1000)
    cfg = tadamw.AdamWConfig(moment_dtype=moments)
    params = port_materialize(tlm.param_spec(tregistry.get_smoke("hymba-1.5b")),
                              torch.Generator().manual_seed(0), "cpu")
    a_p, a_s = params, tadamw.adamw_init(params, cfg)
    b_p = tree_map(lambda t: t.clone(), a_p)
    b_s = tree_map(lambda t: t.clone(), a_s)
    gen = torch.Generator().manual_seed(1)
    for i in range(3):
        grads = tree_map(lambda t: torch.randn(t.shape, generator=gen).to(t.dtype), params)
        lr = tsteps.lr_schedule(a_s["step"], 1e-2, warmup=2)
        a_p, a_s = tadamw.adamw_update(grads, a_p, a_s, lr, cfg)
        out_p, out_s = tadamw.adamw_update_(grads, b_p, b_s, lr, cfg)
        assert out_p is b_p and out_s is b_s
        for (path, _, x), (_, _, y) in zip(leaves_with_path([a_p, a_s]),
                                           leaves_with_path([b_p, b_s])):
            assert torch.equal(x, y), (i, path)
