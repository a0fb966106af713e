"""The port's training batches: ``concrete_batch``'s leaves have the JAX
package's shapes and dtypes for every arch (with and without gradient
accumulation), the vision stub's ``pos3d`` equals the JAX one bit for bit,
and the pipelines are pure functions of ``(seed, step)`` drawing from the
reference's distributions (``jax.random``'s draws themselves cannot be
reproduced)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.data import synthetic as jsynthetic
from repro.launch import specs as jspecs
from repro.models import registry as jregistry
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import synthetic
from repro_torch.launch import specs
from repro_torch.models import registry


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_concrete_batch_shapes_match_jax(arch, accum):
    """Every leaf's shape and dtype against the JAX ``_batch_shapes`` and
    ``_batch_dtypes`` (the specs the JAX ``concrete_batch`` fills) at B = 4,
    S = 64, the smoke cell's size."""
    jcfg, cfg = jregistry.get_smoke(arch), registry.get_smoke(arch)
    shapes = jspecs._batch_shapes(jcfg, JaxShapeConfig("t", 64, 4, "train"), accum)
    assert specs._batch_shapes(cfg, ShapeConfig("t", 64, 4, "train"), accum) == shapes
    got = specs.concrete_batch(cfg, ShapeConfig("t", 64, 4, "train"), 0, 0, accum=accum)
    assert sorted(got) == sorted(shapes)
    for k, shape in shapes.items():
        assert tuple(got[k].shape) == shape, k
        assert str(got[k].dtype).removeprefix("torch.") == jspecs._batch_dtypes(k).__name__, k


def test_pos3d_matches_jax_bit_for_bit():
    """qwen2-vl's M-RoPE ids: the patch grid at (0, h, w), text at i + side;
    ``n_patches`` snapping down to a square (16 → 4 x 4, 20 → 4 x 4, 3 → 1)."""
    for seq, n_patches in ((64, 16), (64, 20), (12, 3)):
        ref = jsynthetic.vlm_stub_batch(0, 0, batch=2, seq=seq, vocab=97, d_model=8,
                                        n_patches=n_patches)
        got = synthetic.vlm_stub_batch(0, 0, batch=2, seq=seq, vocab=97, d_model=8,
                                       n_patches=n_patches)
        np.testing.assert_array_equal(got["pos3d"].numpy(), np.asarray(ref["pos3d"]))
        assert got["patch_embeds"].shape == ref["patch_embeds"].shape
        assert got["patch_embeds"].dtype == torch.float32


def test_data_pipeline_step_indexed():
    """``tests/test_checkpoint.py``'s case on the port: the same (seed, step)
    gives the same batch, another step another one; labels are the tokens
    one position on."""
    a = synthetic.lm_batch(0, 41, batch=2, seq=16, vocab=97)
    b = synthetic.lm_batch(0, 41, batch=2, seq=16, vocab=97)
    c = synthetic.lm_batch(0, 42, batch=2, seq=16, vocab=97)
    d = synthetic.lm_batch(1, 41, batch=2, seq=16, vocab=97)
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["labels"], b["labels"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert not torch.equal(a["tokens"], d["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    v = synthetic.vlm_stub_batch(3, 5, batch=2, seq=16, vocab=97, d_model=8, n_patches=4)
    w = synthetic.vlm_stub_batch(3, 5, batch=2, seq=16, vocab=97, d_model=8, n_patches=4)
    assert torch.equal(v["patch_embeds"], w["patch_embeds"])


def test_lm_batch_follows_the_reference_mixture():
    """Each row is an affine ramp (a·i + b) % V with a in [1, 7) or a motif
    of period 3..16 repeated, about half of each; MusicGen's codebook k is
    the stream shifted by k mod V."""
    V, S = 1009, 64
    out = synthetic.lm_batch(7, 0, batch=256, seq=S, vocab=V)
    toks = torch.cat([out["tokens"], out["labels"][:, -1:]], dim=1).numpy().astype(np.int64)
    ramps = 0
    for row in toks:
        steps = np.unique((row[1:] - row[:-1]) % V)
        if len(steps) == 1 and 1 <= steps[0] < 7:
            ramps += 1
        else:
            period = next(p for p in range(3, 17) if np.array_equal(row[p:], row[:-p]))
            assert 3 <= period <= 16
    assert 0.35 < ramps / 256 < 0.65
    cb = synthetic.audio_stub_batch(7, 0, batch=3, seq=S, vocab=V, n_codebooks=4)
    assert tuple(cb["tokens"].shape) == (3, 4, S)
    for k in range(4):
        assert torch.equal(cb["tokens"][:, k], (cb["tokens"][:, 0] + k) % V)
