"""The port's checkpoints (``repro_torch/checkpoint/ckpt.py``): the families
of ``tests/test_checkpoint.py`` (roundtrip, ``.tmp`` debris ignored and
collected, the keep policy, corruption, shape and dtype mismatches), and the
format shared with the JAX package: a checkpoint written by the JAX
``train_loop`` restores in the port bit for bit (bf16 weights, int8 moments,
float32 scales, int32 counters) and the port's train step continues from it
as the JAX one does; one written by the port's ``train_loop`` restores
through the JAX ``ckpt.restore`` bit for bit."""
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.checkpoint import ckpt as jckpt
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.launch import specs as jspecs
from repro.launch import train as jtrain
from repro.models import registry as jregistry
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro_torch.bridge import tree_to_numpy
from repro_torch.checkpoint import ckpt
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_step
from repro_torch.models import registry
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.tree import leaves_with_path


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 4), generator=g),
                       "b": torch.randn((3, 5), generator=g).to(torch.bfloat16),
                       "m": torch.zeros((8, 4), dtype=torch.int8)},
            "step": torch.tensor(3, dtype=torch.int32)}


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's stored bits (bf16 as uint16, as the npz stores it)."""
    t = t.detach().cpu()
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()


def test_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 3, t)
    out, step = ckpt.restore(str(tmp_path), 3, _tree(1), verify=True)
    assert step == 3
    for (pa, _, a), (pb, _, b) in zip(leaves_with_path(t), leaves_with_path(out)):
        assert pa == pb and a.dtype == b.dtype
        assert torch.equal(a, b), pa


def test_tmp_dirs_ignored_and_gced(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, _tree())
    os.makedirs(os.path.join(d, "step_000000002.tmp"))       # crash debris
    assert ckpt.latest_step(d) == 1                          # ignored
    ckpt.save(d, 3, _tree())
    assert not any(n.endswith(".tmp") for n in os.listdir(d))  # collected


def test_keep_policy(tmp_path):
    d = str(tmp_path)
    for s in range(6):
        ckpt.save(d, s, _tree(), keep=2)
    assert ckpt.all_steps(d) == [4, 5]


def test_corruption_detected(tmp_path):
    d = str(tmp_path)
    path = ckpt.save(d, 1, _tree())
    npz = os.path.join(path, "arrays.npz")
    raw = open(npz, "rb").read()
    open(npz, "wb").write(raw[:-50] + bytes(b ^ 0xFF for b in raw[-50:]))
    with pytest.raises(Exception):
        ckpt.restore(d, 1, _tree(), verify=True)


def test_content_hash_mismatch_rejected(tmp_path):
    """A leaf whose stored bytes no longer match the manifest's sha256."""
    d = str(tmp_path)
    path = ckpt.save(d, 1, _tree())
    man = os.path.join(path, "manifest.json")
    meta = json.load(open(man))
    meta["leaves"]["['params']['w']"]["sha256"] = "0" * 16
    json.dump(meta, open(man, "w"))
    ckpt.restore(d, 1, _tree())                                # not verified: loads
    with pytest.raises(ckpt.CheckpointError, match="hash"):
        ckpt.restore(d, 1, _tree(), verify=True)


@pytest.mark.parametrize("bad", ["shape", "dtype", "missing", "extra"])
def test_template_mismatch_rejected(tmp_path, bad):
    d = str(tmp_path)
    ckpt.save(d, 1, _tree())
    tpl = _tree()
    if bad == "shape":
        tpl["params"]["w"] = torch.zeros((9, 4))
    elif bad == "dtype":
        tpl["params"]["b"] = torch.zeros((3, 5))
    elif bad == "missing":
        del tpl["params"]["m"]
    else:
        tpl["params"]["z"] = torch.zeros(2)
    with pytest.raises(ckpt.CheckpointError):
        ckpt.restore(d, 1, tpl)
    with pytest.raises(ckpt.CheckpointError):
        ckpt.restore(d, 2, _tree())                            # no such step


# ---------------------------------------------------------------------------
# the format shared with the JAX package
# ---------------------------------------------------------------------------

ARCH = "xlstm-350m"
KW = dict(batch=2, seq=32, seed=0)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX ``train_loop`` on xlstm's smoke config (bf16 weights, float32
    ``r_zifo``, int8 moments): 5 steps, checkpoints at steps 3 and 5."""
    d = str(tmp_path_factory.mktemp("jax_run"))
    _, losses = jtrain.train_loop(jregistry.get_smoke(ARCH), steps=5, ckpt_dir=d,
                                  save_every=3, opt_cfg=JaxAdamWConfig(moment_dtype="int8"),
                                  log_every=100, **KW)
    return d, losses


def _port_state():
    return train.build_state(registry.get_smoke(ARCH), torch.Generator().manual_seed(1),
                             AdamWConfig(moment_dtype="int8"), "cpu")


def test_jax_checkpoint_restores_in_the_port(jax_run):
    """Every leaf of the JAX step-3 checkpoint comes back bit for bit, with its
    dtype: bf16 weights, float32 leaves, int8 moment codes, float32 scales,
    the int32 step counters."""
    d, _ = jax_run
    state, step = ckpt.restore(d, 3, _port_state(), verify=True)
    assert step == 3
    man = json.load(open(os.path.join(d, "step_000000003", "manifest.json")))["leaves"]
    dtypes = set()
    with np.load(os.path.join(d, "step_000000003", "arrays.npz")) as data:
        for path, _, leaf in leaves_with_path(state):
            raw = data[ckpt._escape(path)]
            assert tuple(leaf.shape) == raw.shape, path
            np.testing.assert_array_equal(_bits(leaf), raw, err_msg=path)
            assert str(leaf.dtype).removeprefix("torch.") == man[path]["dtype"], path
            dtypes.add(man[path]["dtype"])
    assert dtypes == {"bfloat16", "float32", "int8", "int32"}
    assert int(state["opt"]["step"]) == int(state["data_step"]) == 3


def test_port_continues_a_jax_run(jax_run, tmp_path):
    """From the JAX step-3 checkpoint, the port's train step on the JAX
    pipeline's step-3 batch gives the JAX run's step-3 loss (bf16 weights:
    the two frameworks round bf16 products differently, rtol 2e-3 where
    the measured gap is 1.4e-4); the port's ``train_loop --resume`` then
    picks the run up at step 3 and takes it to step 5."""
    d, losses = jax_run
    state, _ = ckpt.restore(d, 3, _port_state())
    cfg = registry.get_smoke(ARCH)
    jb = jspecs.concrete_batch(jregistry.get_smoke(ARCH), JaxShapeConfig("train", 32, 2, "train"),
                               0, 3)
    batch = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jb.items()}
    _, opt, m = make_train_step(cfg, AdamWConfig(moment_dtype="int8"), warmup=5)(
        state["params"], state["opt"], batch)
    np.testing.assert_allclose(float(m["loss"]), losses[3], rtol=2e-3)
    assert int(opt["step"]) == 4
    d2 = str(tmp_path / "resume")
    shutil.copytree(os.path.join(d, "step_000000003"), os.path.join(d2, "step_000000003"))
    final, port_losses = train.train_loop(cfg, steps=5, ckpt_dir=d2, resume=True, save_every=5,
                                          opt_cfg=AdamWConfig(moment_dtype="int8"),
                                          device="cpu", **KW)
    assert len(port_losses) == 2 and all(np.isfinite(port_losses))
    assert int(final["opt"]["step"]) == int(final["data_step"]) == 5
    assert ckpt.latest_step(d2) == 5


def test_port_checkpoint_restores_in_jax(tmp_path):
    """The port's ``train_loop`` (2 steps, int8 moments) writes a checkpoint
    that the JAX ``ckpt.restore`` loads against the JAX ``build_state``'s
    structure, every leaf bit for bit and of the JAX dtype."""
    d = str(tmp_path)
    cfg, jcfg = registry.get_smoke(ARCH), jregistry.get_smoke(ARCH)
    state, _ = train.train_loop(cfg, steps=2, ckpt_dir=d, save_every=2,
                                opt_cfg=AdamWConfig(moment_dtype="int8"), device="cpu", **KW)
    opt_cfg = JaxAdamWConfig(moment_dtype="int8")
    tpl = jax.eval_shape(lambda: jtrain.build_state(jcfg, jax.random.PRNGKey(0), opt_cfg))
    restored, step = jckpt.restore(d, 2, tpl, verify=True)
    assert step == 2
    ours = {path: leaf for path, _, leaf in leaves_with_path(tree_to_numpy(state))}
    flat, _ = jax.tree_util.tree_flatten_with_path(restored)
    assert len(flat) == len(ours)
    for path, leaf in flat:
        key = jax.tree_util.keystr(path)
        a, b = np.asarray(leaf), ours[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8),
                                      err_msg=key)
