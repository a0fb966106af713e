"""The port's sharded static loop against one device and the JAX package:
a sharded prefill into caches placed by ``launch/specs.py cache_pspecs``
(batch on ``data``, cache rows on ``model``), then sharded decode steps
whose attention is a flash decode over each rank's own cache rows, on four
gloo ranks of a (2, 2) mesh (``tests/torch_dist_jobs.py job_decode``).

Four smoke configs in float32 with float32 caches: phi4-mini (dense GQA),
deepseek-v3 (MLA's latent cache, MoE routed in the reference's global
order), hymba (a ring of 8 rows, 4 a rank, which wraps; the SSM state) and
xlstm (mLSTM and sLSTM states).  Four prompts of 6 tokens, 4 decode steps,
caches of 16 rows: model rank 1's rows are all invisible at the first
decode steps and written by the last ones.

Tolerances, each at most 4× the worst measured here (on this CPU, torch
2.13):

* rank 0's logits against the port's one-device ``make_prefill_step`` and
  ``make_decode_step``: 1.6e-5 (worst 4.05e-6, xlstm; the sharded products
  sum FSDP-sharded rows as partial sums and the flash decode combines its
  softmax partials across ranks, both reordered float32 sums);
* the gathered caches against one device, relative to each leaf's largest
  entry: 6e-6 (worst 1.49e-6, an xlstm state);
* the prefill logits, sharded and one-device, against the JAX package's:
  1.1e-5 (worst 2.76e-6, xlstm; XLA and PyTorch sum in other orders);
* ``sdpa`` on DTensors past its blockwise threshold (48 rows, threshold
  16, chunk 4) against one device: 1.6e-6 (worst 4.17e-7, the largest
  output 2.49; the sharded blocks attend in chunks of the threshold's
  rows, one device in the caller's, so the online softmax rescales in
  another order).

Greedy tokens must be equal in all three; a step where the reference's
top-2 logit gap is within the logit tolerance would be reported, not
absorbed (none is at this seed).
"""
import os
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from serving_harness import materialize  # noqa: E402
from test_torch_distributed import _spawn  # noqa: E402

from repro.launch import steps as jsteps  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.launch.steps import static_loop  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_jobs as jobs  # noqa: E402

TOL_SHARDED = 1.6e-5
TOL_CACHE = 6e-6
TOL_JAX = 1.1e-5
TOL_LONG_SDPA = 1.6e-6


def _jax_static_loop(cfg, params, prompts, gen, max_len):
    prefill = jax.jit(jsteps.make_prefill_step(cfg, max_len=max_len))
    decode = jax.jit(jsteps.make_decode_step(cfg))
    last, caches = prefill(params, {"tokens": jnp.asarray(prompts)})
    tok = jnp.argmax(last, axis=-1).astype(jnp.int32)[..., None]
    toks = [tok]
    for _ in range(gen):
        tok, caches = decode(params, caches, tok)
        toks.append(tok)
    return np.asarray(last), np.asarray(jnp.concatenate(toks, axis=-1))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per arch: the sharded loop's gathered outputs (rank 0 of the gloo
    job), the port's one-device loop and the JAX package's, from the JAX
    package's float32 params and the same prompts."""
    d = str(tmp_path_factory.mktemp("decode"))
    rng = np.random.default_rng(0)
    prompts, one, ref = {}, {}, {}
    for arch in jobs.DECODE_ARCHS:
        jcfg, jparams = materialize(arch)
        jcfg = jcfg.with_overrides(kv_dtype="float32")
        host = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
        tparams = params_from_numpy(host, "cpu", dtype=torch.float32)
        np.savez(os.path.join(d, f"{arch}.npz"),
                 **{p: t.numpy() for p, _, t in leaves_with_path(tparams)})
        prompts[arch] = rng.integers(0, jcfg.vocab, size=(jobs.DECODE["batch"],
                                                          jobs.DECODE["prompt"]),
                                     dtype=np.int32)
        tcfg = registry.get_smoke(arch).with_overrides(kv_dtype="float32")
        one[arch] = static_loop(tcfg, tparams, torch.from_numpy(prompts[arch]),
                                jobs.DECODE["gen"], jobs.DECODE["max_len"])
        ref[arch] = _jax_static_loop(jcfg, jax.tree.map(jnp.asarray, host), prompts[arch],
                                     jobs.DECODE["gen"], jobs.DECODE["max_len"])
    np.savez(os.path.join(d, "prompts.npz"), **prompts)
    _spawn("decode", 4, d)
    with np.load(os.path.join(d, "decode.npz")) as z:
        return dict(z), one, ref


def _near_ties(logits, tol):
    """Rows whose top-2 logit gap is within ``tol``."""
    top = np.sort(logits, axis=-1)[..., -2:]
    return int(np.count_nonzero(top[..., 1] - top[..., 0] <= tol))


@pytest.mark.parametrize("arch", jobs.DECODE_ARCHS)
def test_sharded_prefill_and_decode_match_one_device(runs, arch):
    z, one, _ = runs
    last, seen, toks, caches = one[arch]
    got = lambda k: z[f"{arch}['{k}']"]
    np.testing.assert_allclose(got("prefill"), last.numpy(), rtol=0, atol=TOL_SHARDED)
    assert got("decode").shape == tuple(seen.shape) == (jobs.DECODE["gen"],
                                                        jobs.DECODE["batch"], seen.shape[-1])
    np.testing.assert_allclose(got("decode"), seen.numpy(), rtol=0, atol=TOL_SHARDED)
    ties = _near_ties(np.concatenate([last.numpy()[None], seen.numpy()]), TOL_SHARDED)
    if not np.array_equal(got("tokens"), toks.numpy()):
        assert ties, (arch, got("tokens"), toks.numpy())
        warnings.warn(f"{arch}: sharded tokens part from one device at {ties} near ties")
    n = 0
    for path, _, leaf in leaves_with_path(caches):
        key = f"{arch}['caches']{path}"
        ref = leaf.numpy().astype(np.float64)
        scale = max(float(np.abs(ref).max()), 1e-30)
        assert np.abs(z[key] - ref).max() <= TOL_CACHE * scale, (key, np.abs(z[key] - ref).max())
        n += 1
    assert n >= 3


@pytest.mark.parametrize("arch", jobs.DECODE_ARCHS)
def test_sharded_prefill_and_decode_match_jax(runs, arch):
    z, one, ref = runs
    jlast, jtoks = ref[arch]
    np.testing.assert_allclose(z[f"{arch}['prefill']"], jlast, rtol=TOL_JAX, atol=TOL_JAX)
    np.testing.assert_allclose(one[arch][0].numpy(), jlast, rtol=TOL_JAX, atol=TOL_JAX)
    for name, toks in (("sharded", z[f"{arch}['tokens']"]), ("one device",
                                                             one[arch][2].numpy())):
        if not np.array_equal(toks, jtoks):
            ties = _near_ties(one[arch][1].numpy(), TOL_JAX)
            assert ties, (arch, name, toks, jtoks)
            warnings.warn(f"{arch}: {name} tokens part from JAX at {ties} near ties")


@pytest.mark.parametrize("window", jobs.LONG_SDPA["windows"])
def test_sharded_sdpa_past_the_blockwise_threshold_matches_one_device(runs, window):
    """``sdpa`` on DTensors past its blockwise threshold, q and k/v batch-
    sharded on ``data`` and head-sharded on ``model``: each rank attends
    over its (batch, head) block in chunks of the threshold's rows, one
    device in the caller's chunks; the outputs agree within float32's
    reordered online softmax."""
    from repro_torch.nn.attention import sdpa

    q, k, v = jobs.long_sdpa_inputs()
    pos = torch.arange(q.shape[1])
    one = sdpa(q, k, v, pos, pos, window, jobs.LONG_SDPA["chunk"], jobs.LONG_SDPA["threshold"])
    got = runs[0][f"long_sdpa['w{window}']"]
    assert got.shape == tuple(one.shape)
    np.testing.assert_allclose(got, one.numpy(), rtol=0, atol=TOL_LONG_SDPA)

