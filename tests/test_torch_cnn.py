"""The port's CNN path (``repro_torch.nn.cnn``, ``data.synthetic``,
``optim.adamw``, ``launch.odin_inference``) against the JAX package.

``cnn_forward`` on CNN1 and CNN2 runs with the JAX params carried across
(``params_from_numpy``), the same numpy images and the JAX LUTs: exact
mode within atol 1e-5 (float32 matmuls summed in another order), int8 and
sc hybrid/8 logits bit for bit (atol 0).  The JAX side runs op by op, as
its own tests run it (see test_torch_odin_linear.py for why not under
``jit``).  ``digits_batch`` draws from numpy, not ``jax.random``, so it is
held to the JAX batch's shapes, range and class balance."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core.odin_linear import OdinConfig as JaxOdinConfig
from repro.core.odin_linear import get_luts as jax_get_luts
from repro.nn import cnn as jcnn
from repro.nn.module import materialize as jax_materialize
from repro.optim import adamw as jadamw
from repro_torch.bridge import luts_from_numpy, params_from_numpy
from repro_torch.core.odin_linear import OdinConfig
from repro_torch.data.synthetic import digits_batch
from repro_torch.launch import odin_inference
from repro_torch.nn import cnn
from repro_torch.optim import adamw

JLUTS = jax_get_luts(256, 256, 0)
LUTS = luts_from_numpy(*JLUTS)
TOPOS = {"cnn1": (cnn.RUNNABLE_CNN1, jcnn.RUNNABLE_CNN1),
         "cnn2": (cnn.RUNNABLE_CNN2, jcnn.RUNNABLE_CNN2)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on the same
    cores, and torch's thread pool oversubscribed by them made the CPU
    training below 50x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("k,stride,pad,C", [(5, 1, 2, 1), (7, 1, 0, 1), (3, 2, 1, 3)])
def test_im2col_exact(k, stride, pad, C):
    x = np.random.default_rng(k).uniform(size=(2, 12, 12, C)).astype(np.float32)
    ours = cnn._im2col(torch.from_numpy(x), k, stride, pad)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jcnn._im2col(jnp.asarray(x), k, stride, pad)))


@pytest.fixture(scope="module", params=["cnn1", "cnn2"])
def net(request):
    topo, jtopo = TOPOS[request.param]
    jparams = jax_materialize(jcnn.cnn_param_spec(jtopo), jax.random.PRNGKey(1))
    np_params = jax.tree.map(np.asarray, jparams)
    images = np.random.default_rng(2).uniform(0.0, 1.0, (2, 28, 28, 1)).astype(np.float32)
    return topo, jtopo, np_params, params_from_numpy(np_params, "cpu"), images


@pytest.mark.parametrize("mode", ["exact", "int8", "sc_hybrid8"])
def test_cnn_forward_matches_jax(net, mode):
    topo, jtopo, np_params, params, images = net
    cfg = {"exact": None, "int8": dict(mode="int8"),
           "sc_hybrid8": dict(mode="sc", signed_activations=False, sc_block_k=8)}[mode]
    ours = cnn.cnn_forward(params, torch.from_numpy(images), topo,
                           None if cfg is None else OdinConfig(**cfg), luts=LUTS)
    theirs = np.asarray(jcnn.cnn_forward(jax.tree.map(jnp.asarray, np_params),
                                         jnp.asarray(images), jtopo,
                                         None if cfg is None else JaxOdinConfig(**cfg)))
    assert ours.shape == (2, 10)
    if cfg is None:
        np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-5, rtol=0)
    else:
        np.testing.assert_array_equal(ours.numpy(), theirs)


def test_param_spec_and_mac_layers_match_jax():
    for topo, jtopo in TOPOS.values():
        ours = cnn.cnn_param_spec(topo)
        theirs = jcnn.cnn_param_spec(jtopo)
        assert {k: v.shape for k, v in ours.items()} == {k: v.shape for k, v in theirs.items()}
        assert cnn.topology_input_hw(topo) == jcnn.topology_input_hw(jtopo)
        assert cnn.mac_layers(topo) == 3


def test_digits_batch_shapes_range_balance():
    b = digits_batch(0, 0, batch=512)
    assert b["image"].shape == (512, 28, 28, 1) and b["image"].dtype == torch.float32
    assert 0.0 <= b["image"].min().item() and b["image"].max().item() <= 1.0
    assert torch.bincount(b["label"], minlength=10).min().item() > 20
    again = digits_batch(0, 0, batch=512)
    assert torch.equal(b["image"], again["image"]) and torch.equal(b["label"], again["label"])
    assert not torch.equal(digits_batch(0, 1, batch=512)["label"], b["label"])


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_adamw_matches_jax_three_steps(moment_dtype):
    rng = np.random.default_rng(4)
    shapes = {"w": (20, 130), "b": (7,), "k": (3, 4, 5)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    cfg = dict(moment_dtype=moment_dtype, weight_decay=0.1)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jadamw.adamw_init(jp, jcfg)
    tp = {k: torch.from_numpy(v) for k, v in p0.items()}
    tstate = adamw.adamw_init(tp, tcfg)
    # under jit, as the JAX package trains; its rounding may part from op
    # by op by an ulp, far inside the tolerance, and it compiles 10x faster
    jupdate = jax.jit(lambda g, p, s: jadamw.adamw_update(g, p, s, 1e-2, jcfg))
    for g in grads:
        jp, jstate = jupdate({k: jnp.asarray(v) for k, v in g.items()}, jp, jstate)
        tp, tstate = adamw.adamw_update({k: torch.from_numpy(v) for k, v in g.items()}, tp,
                                        tstate, 1e-2, tcfg)
    assert int(tstate["step"]) == 3
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0)
        for m in ("mu", "nu"):
            for leaf in tstate[m][k]:
                np.testing.assert_allclose(tstate[m][k][leaf].numpy().astype(np.float32),
                                           np.asarray(jstate[m][k][leaf]).astype(np.float32),
                                           atol=1e-6, rtol=1e-6)


def test_odin_inference_trains_and_keeps_the_paper_gaps():
    """The entry point on the CPU: CNN1 trained for the JAX fixture's 120
    steps, then the JAX suite's accuracy thresholds (tests/test_system.py)
    on 2 x 16 held-out images."""
    out = odin_inference.run(steps=120, batch=64, n_eval=2, eval_batch=16, device="cpu",
                             log=lambda *a: None)
    res = out["result"]
    acc = res["accuracy"]
    assert res["device"] == "cpu" and res["eval_images"] == 32
    assert res["last_train_step"]["acc"] > 0.8
    assert acc["fp32"] > 0.8
    assert abs(acc["fp32"] - acc["int8"]) < 0.05
    assert acc["sc_hybrid8"] > 0.55
    assert acc["sc_full_tree"] < 0.5
    assert set(res["images_per_s"]) == {name for name, _ in odin_inference.MODES}
    assert res["pcram_model"]["macs"] > 0


def test_entry_point_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        odin_inference.run(steps=1, n_eval=1, eval_batch=2, log=lambda *a: None)
