"""The port's weight bridge, layers and LM forward against the JAX package.

Weights come from the JAX package's ``materialize`` and cross through
``repro_torch.bridge``.  Layers are compared in float32 at atol 1e-6.  The
LM forward runs phi4-mini smoke through a prefill and then decode steps on
paged float32 caches; logits agree within atol 1e-4 / rtol 1e-4 — the two
frameworks sum the matmuls in different orders."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from serving_harness import materialize, run_workload
from test_torch_engine import run_port

from repro.launch.steps import init_serving_caches as jax_init_serving_caches
from repro.models import lm as jlm
from repro.models import registry as jregistry
from repro.nn import blocks as jblocks
from repro.nn import layers as jlayers
from repro.nn import module as jmodule
from repro_torch.bridge import params_from_numpy
from repro_torch.launch.steps import init_serving_caches
from repro_torch.models import lm as tlm
from repro_torch.models import registry as tregistry
from repro_torch.nn import blocks as tblocks
from repro_torch.nn import layers as tlayers
from repro_torch.nn import module as tmodule
from repro_torch.tree import leaves_with_path

ARCH = "phi4-mini-3.8b"


@pytest.fixture(scope="module")
def jax_params():
    cfg = jregistry.get_smoke(ARCH)
    params = jmodule.materialize(jlm.param_spec(cfg), jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("which", ["get_config", "get_smoke"])
def test_configs_are_the_reference_configs(which):
    for arch in tregistry.ARCH_IDS:
        ours, theirs = getattr(tregistry, which)(arch), getattr(jregistry, which)(arch)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert tmodule.count_params(tlm.param_spec(ours)) == jmodule.count_params(
            jlm.param_spec(theirs))
        assert tlm.model_flops(ours, 7, train=False) == jlm.model_flops(theirs, 7,
                                                                        train=False)
        assert tlm.model_flops(ours, 7) == jlm.model_flops(theirs, 7)


def test_every_reference_arch_is_ported():
    assert tregistry.ARCH_IDS == jregistry.ARCH_IDS


@pytest.mark.parametrize("init", ["normal", "fan_in"])
def test_materialize_draws_large_leaves_in_pieces(init, monkeypatch):
    """A leaf whose float32 draw passes ``MAX_DRAW_BYTES`` is drawn in pieces
    of whole rows along its leading axes, none larger than the limit: the
    leaf keeps its shape and dtype, every row is filled, and the values
    keep the init's standard deviation (``normal`` 0.02, ``fan_in``
    1/sqrt(fan_in)).  Within the limit the leaf equals one whole draw."""
    spec = {"w": tmodule.ParamSpec((3, 5, 64, 48), ("layers", "experts", "embed", "mlp"),
                                   torch.bfloat16, init=init)}
    limit = 4 * 2 * 64 * 48 - 4        # below one [64, 48] block: pieces of rows
    draws, randn = [], torch.randn

    def recorded(shape, **kw):
        draws.append(tuple(shape))
        return randn(shape, **kw)

    monkeypatch.setattr(torch, "randn", recorded)
    monkeypatch.setattr(tmodule, "MAX_DRAW_BYTES", limit)
    w = tmodule.materialize(spec, torch.Generator().manual_seed(0), "cpu")["w"]
    assert w.shape == (3, 5, 64, 48) and w.dtype == torch.bfloat16
    assert len(draws) > 1 and all(4 * np.prod(d) <= limit for d in draws)
    assert sum(np.prod(d) for d in draws) == w.numel()
    std = 0.02 if init == "normal" else 1 / np.sqrt(3 * 5 * 64)
    x = w.float()
    assert abs(x.std().item() / std - 1) < 0.02 and abs(x.mean().item()) < 0.02 * std
    assert bool((x.reshape(-1, 48).std(dim=1) > 0.5 * std).all())
    # within the limit the leaf is one draw: the whole leaf's N(0, 1) values
    # from the same seed, scaled and cast
    monkeypatch.setattr(tmodule, "MAX_DRAW_BYTES", 4 * w.numel())
    w = tmodule.materialize(spec, torch.Generator().manual_seed(0), "cpu")["w"]
    whole = randn((3, 5, 64, 48), generator=torch.Generator().manual_seed(0))
    assert w.shape == (3, 5, 64, 48) and w.dtype == torch.bfloat16
    assert torch.equal(w, whole.mul_(std).to(torch.bfloat16))


def _flat(tree):
    return {path: leaf for path, _, leaf in leaves_with_path(tree)}


def test_bridge_bf16_bit_for_bit(jax_params):
    ours = _flat(params_from_numpy(jax_params, "cpu"))
    theirs = _flat(jax_params)
    assert ours.keys() == theirs.keys()
    n_bf16 = 0
    for path, a in theirs.items():
        t = ours[path]
        assert tuple(t.shape) == a.shape, path
        if a.dtype.name == "bfloat16":
            n_bf16 += 1
            assert t.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                          a.view(np.uint16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)
    assert n_bf16 > 0


def test_bridge_float32_cast(jax_params):
    ours = _flat(params_from_numpy(jax_params, "cpu", dtype=torch.float32))
    for path, a in _flat(jax_params).items():
        assert ours[path].dtype == torch.float32
        np.testing.assert_array_equal(ours[path].numpy(), a.astype(np.float32))


def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    g = rng.normal(size=(16,)).astype(np.float32)
    pos = rng.integers(0, 300, size=(2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        tlayers.rmsnorm(torch.from_numpy(x), torch.from_numpy(g)).numpy(),
        np.asarray(jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(g))), atol=1e-6)
    np.testing.assert_allclose(
        tlayers.layernorm(torch.from_numpy(x), torch.from_numpy(g)).numpy(),
        np.asarray(jlayers.layernorm(jnp.asarray(x), jnp.asarray(g))), atol=1e-6)
    np.testing.assert_allclose(
        tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)),
        atol=1e-6)
    for kind in ("gelu", "relu2", "swiglu"):
        np.testing.assert_allclose(
            tlayers.activation(torch.from_numpy(x), kind).numpy(),
            np.asarray(jlayers.activation(jnp.asarray(x), kind)), atol=1e-6)


def test_swiglu_mlp_matches_jax():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(2, 3, 64)) * 0.5).astype(np.float32)
    p = {n: (rng.normal(size=s) * 0.1).astype(np.float32)
         for n, s in (("w_gate", (64, 128)), ("w_up", (64, 128)), ("w_down", (128, 64)))}
    ours = tblocks._mlp({n: torch.from_numpy(a) for n, a in p.items()},
                        torch.from_numpy(x), "swiglu", None).numpy()
    theirs = np.asarray(jblocks._mlp({n: jnp.asarray(a) for n, a in p.items()},
                                     jnp.asarray(x), "swiglu", None))
    np.testing.assert_allclose(ours, theirs, atol=1e-6)


def test_forward_prefill_then_decode_on_paged_caches(jax_params):
    cfg = jregistry.get_smoke(ARCH).with_overrides(kv_dtype="float32")
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jax_params)
    tparams = params_from_numpy(jax_params, "cpu", dtype=torch.float32)
    B, bs, n_blocks, max_len = 2, 8, 8, 32
    jc = jax_init_serving_caches(cfg, B, max_len, block_size=bs, n_blocks=n_blocks)
    tc = init_serving_caches(cfg, B, max_len, block_size=bs, n_blocks=n_blocks,
                             device="cpu")
    tables = np.arange(B * 4, dtype=np.int32).reshape(B, 4)[:, ::-1].copy()
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab, size=(B, 8)).astype(np.int32)
    jl, jc, _ = jlm.forward(jparams, jnp.asarray(prompt), cfg, caches=jc,
                            tables=jnp.asarray(tables))
    tl, tc, _ = tlm.forward(tparams, torch.from_numpy(prompt), cfg, caches=tc,
                            tables=torch.from_numpy(tables))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    for step in range(3):
        tok = rng.integers(0, cfg.vocab, size=(B, 1)).astype(np.int32)
        pos = np.full((B, 1), 8 + step, np.int32)
        jl, jc, _ = jlm.forward(jparams, jnp.asarray(tok), cfg, caches=jc,
                                start_pos=jnp.asarray(pos), tables=jnp.asarray(tables))
        tl, tc, _ = tlm.forward(tparams, torch.from_numpy(tok), cfg, caches=tc,
                                start_pos=torch.from_numpy(pos),
                                tables=torch.from_numpy(tables))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(tc[0]["attn"]["pos"].numpy(),
                                  np.asarray(jc[0]["attn"]["pos"]))
    np.testing.assert_allclose(tc[0]["attn"]["k_pool"].numpy(),
                               np.asarray(jc[0]["attn"]["k_pool"]), atol=1e-5)


def test_moe_model_flops_count_active_params():
    """qwen3-moe-235b-a22b: 235.09 B parameters, 22.19 B active a token
    (8 of 128 routed experts), as the JAX package counts them."""
    cfg = tregistry.get_config("qwen3-moe-235b-a22b")
    total = tmodule.count_params(tlm.param_spec(cfg))
    active = tlm.model_flops(cfg, 1, train=False) / 2
    assert round(total / 1e9, 2) == 235.09 and round(active / 1e9, 2) == 22.19


@pytest.mark.parametrize("arch", ["nemotron-4-15b", "phi3-medium-14b", "llama3-405b"])
def test_dense_gqa_smoke_configs_match_jax(arch):
    """The dense GQA configs that run only ported paths (nemotron's relu²,
    phi3-medium's and llama3's swiglu; 4 query heads over 2 KV heads of 16
    at smoke size), float32: ``lm.forward`` over a 12-token prompt within
    1e-5 of the JAX forward, and the engine's greedy streams on
    ``mixed_spec()`` equal to the JAX engine's with the defaults (mixed
    dispatch and prefix sharing on, as the model is fully paged)."""
    jcfg, jparams = materialize(arch)
    host = jax.tree.map(np.asarray, jparams)
    jcfg = jcfg.with_overrides(kv_dtype="float32")
    jparams = jax.tree.map(lambda a: a.astype(np.float32), jparams)
    tcfg = tregistry.get_smoke(arch).with_overrides(kv_dtype="float32")
    tparams = params_from_numpy(host, "cpu", dtype=torch.float32)
    tokens = np.random.default_rng(4).integers(0, tcfg.vocab, size=(2, 12)).astype(np.int32)
    jl = np.asarray(jlm.forward(jparams, jnp.asarray(tokens), jcfg)[0])
    tl = tlm.forward(tparams, torch.from_numpy(tokens), tcfg)[0].numpy()
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    ours, summary, _ = run_port(tcfg, tparams)
    theirs, jsummary = run_workload(jcfg, jparams)
    assert ours == theirs
    assert summary["generated_tokens"] == jsummary["generated_tokens"]
    assert summary["kv_cache_bytes"] == jsummary["kv_cache_bytes"] > 0
    assert summary["mixed"]["dispatches"] > 0
