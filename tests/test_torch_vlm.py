"""qwen2-vl-2b smoke (2 layers, M-RoPE sections (2, 3, 3), 4 query heads
over 2 KV heads of 16) through the port's LM and ServingEngine, against the
JAX package.

A vision request carries the stub's extras: ``patch_embeds [P, d]``, which
overlay the embeddings of its first P positions, and ``pos3d [S, 3]``, the
(t, h, w) ids M-RoPE turns q and k by (patches at (0, h, w) on a square
grid, text token i at i + side on every axis).  Decode steps, text-only
prompts and the generated tail of a recompute replay take (t, t, t).
Weights are the JAX package's ``materialize`` of the smoke config, carried
across by the bridge in float32 unless a test says otherwise.

* ``apply_mrope`` within 1e-6 of the JAX function at the smoke sections
  (D = 16) and the published ones (D = 128); without ``pos3d`` attention
  rotates exactly as RoPE does.
* ``lm.forward`` on 16 tokens with 4 patch rows and ``vlm_stub_extras``'
  ``pos3d``: within 1e-5 in float32, and within ``BF16_NORMWISE`` of the
  largest logit with the bf16 weights.
* ``vlm_stub_extras``' ``pos3d`` equals the JAX ``vlm_stub_batch``'s bit
  for bit.
* Engine greedy streams equal the JAX engine's: extras requests under
  recompute preemption (and equal to the unconstrained run), the same
  prompt with different patches (no prefix shared), text-only and extras
  requests together (mixed dispatch for the text-only ones alone); an
  extras request whose worst replay passes the chunk is refused at submit;
  the static loop with extras equals the engine and the JAX static loop.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from serving_harness import materialize, run_workload, token_streams

from repro.data import synthetic as jsynthetic
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.nn import layers as jlayers
from repro.serving import Request as JaxRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.data import vlm_stub_extras
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.models import registry as tregistry
from repro_torch.nn import attention as tattention
from repro_torch.nn import layers as tlayers
from repro_torch.serving import Request, ServingEngine
from repro_torch.tree import tree_map

ARCH = "qwen2-vl-2b"
TOL = 1e-5
# bf16 logits: the two packages round the bf16 matmuls of the layers at
# different points; bounded normwise, as tests/test_torch_moe.py bounds
# its bf16 difference
BF16_NORMWISE = 2.0 ** -5
PROMPT, PATCHES = 16, 4


@pytest.fixture(scope="module")
def models():
    jcfg, jparams = materialize(ARCH)
    host = jax.tree.map(np.asarray, jparams)
    tcfg = tregistry.get_smoke(ARCH)
    return {"jax16": (jcfg, jparams),
            "jax32": (jcfg.with_overrides(kv_dtype="float32"),
                      jax.tree.map(lambda a: a.astype(np.float32), jparams)),
            "torch16": (tcfg, params_from_numpy(host, "cpu")),
            "torch32": (tcfg.with_overrides(kv_dtype="float32"),
                        params_from_numpy(host, "cpu", dtype=torch.float32))}


def test_bridge_carries_every_leaf(models):
    """Every leaf of the JAX tree crosses bit for bit in the dtype the
    port's spec gives it; the head is untied."""
    from repro_torch.tree import leaves_with_path
    cfg, ours = models["torch16"]
    host = jax.tree.map(np.asarray, models["jax16"][1])
    ours = {p: t for p, _, t in leaves_with_path(ours)}
    theirs = {p: a for p, _, a in leaves_with_path(host)}
    spec = {p: s for p, _, s in leaves_with_path(tlm.param_spec(cfg))}
    assert ours.keys() == theirs.keys() == spec.keys()
    for p, a in theirs.items():
        assert tuple(ours[p].shape) == a.shape == spec[p].shape and ours[p].dtype == spec[p].dtype
        if a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(
                ours[p].view(torch.int16).numpy().view(np.uint16), a.view(np.uint16))
        else:
            np.testing.assert_array_equal(ours[p].numpy(), a)
    assert spec["['lm_head']"].shape == (cfg.d_model, cfg.vocab)


def _pos3d(rng, batch, seq, n_patches):
    """The stub's patch grid and text rows, the text rows of each sequence
    moved by a random offset."""
    pos = vlm_stub_extras(0, batch=batch, seq=seq, d_model=1, n_patches=n_patches)["pos3d"]
    side = int(np.sqrt(n_patches))
    pos[:, side * side:] += rng.integers(0, 4096, size=(batch, 1, 1), dtype=np.int32)
    return pos


@pytest.mark.parametrize("sections,D", [((2, 3, 3), 16), ((16, 24, 24), 128)])
def test_apply_mrope_matches_jax(sections, D):
    rng = np.random.default_rng(sum(sections))
    x = rng.standard_normal((2, 40, 3, D)).astype(np.float32)
    pos = _pos3d(rng, 2, 40, 16)
    ours = tlayers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), sections).numpy()
    theirs = np.asarray(jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections))
    np.testing.assert_allclose(ours, theirs, atol=1e-6, rtol=0)


def test_mrope_without_pos3d_is_rope(models):
    """(t, t, t) turns every section by t: ``apply_mrope`` equals
    ``apply_rope`` bit for bit, and an M-RoPE attention layer given no
    ``pos3d`` equals one given (t, t, t)."""
    cfg, params = models["torch32"]
    acfg = cfg.blocks[0].attn
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 9, 4, 16)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 5000, size=(2, 9), dtype=np.int32))
    t3 = t[..., None].expand(2, 9, 3)
    assert torch.equal(tlayers.apply_mrope(x, t3, acfg.mrope_sections),
                       tlayers.apply_rope(x, t))
    p0 = tree_map(lambda a: a[0], params["segments"][0])["attn"]
    h = torch.from_numpy(rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32))
    plain, _ = tattention.attention(p0, h, acfg, positions=t)
    given, _ = tattention.attention(p0, h, acfg, positions=t, pos3d=t3)
    assert torch.equal(plain, given)


@pytest.mark.parametrize("seq", [16, 448])
def test_vlm_stub_extras_pos3d_equals_jax(seq):
    ours = vlm_stub_extras(3, batch=2, seq=seq, d_model=32, n_patches=seq // 4)
    theirs = jsynthetic.vlm_stub_batch(3, 0, batch=2, seq=seq, vocab=64, d_model=32,
                                       n_patches=seq // 4)
    np.testing.assert_array_equal(ours["pos3d"], np.asarray(theirs["pos3d"]))
    assert ours["pos3d"].dtype == np.int32
    assert ours["patch_embeds"].shape == np.asarray(theirs["patch_embeds"]).shape
    assert ours["patch_embeds"].dtype == np.float32
    assert abs(ours["patch_embeds"].std() / 0.02 - 1) < 0.1


def _forward_inputs(cfg):
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab, size=(2, PROMPT)).astype(np.int32)
    ex = vlm_stub_extras(7, batch=2, seq=PROMPT, d_model=cfg.d_model, n_patches=PATCHES)
    return tokens, ex["patch_embeds"], ex["pos3d"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(models, dtype):
    jcfg, jparams = models["jax32" if dtype == "float32" else "jax16"]
    tcfg, tparams = models["torch32" if dtype == "float32" else "torch16"]
    tokens, patch, pos3d = _forward_inputs(tcfg)
    jl = np.asarray(jlm.forward(jparams, jnp.asarray(tokens), jcfg,
                                patch_embeds=jnp.asarray(patch),
                                pos3d=jnp.asarray(pos3d))[0]).astype(np.float32)
    tl = tlm.forward(tparams, torch.from_numpy(tokens), tcfg,
                     patch_embeds=torch.from_numpy(patch),
                     pos3d=torch.from_numpy(pos3d))[0].float().numpy()
    assert tl.shape == (2, PROMPT, tcfg.vocab)
    if dtype == "float32":
        np.testing.assert_allclose(tl, jl, atol=TOL, rtol=0)
        # the extras reach the logits
        bare = tlm.forward(tparams, torch.from_numpy(tokens), tcfg)[0].numpy()
        assert np.abs(bare - jl).max() > 100 * TOL
    else:
        err = np.abs(tl - jl).max()
        print(f"bf16 forward: max |port - jax| {err:.3e}, max |logit| {np.abs(jl).max():.3f}")
        assert err <= BF16_NORMWISE * np.abs(jl).max()


def _requests(cfg, n, *, prompt_len=PROMPT, max_new=24, extras=True, seed=0,
              same_prompt=False, cls=Request):
    rng = np.random.default_rng(seed)
    ex = vlm_stub_extras(seed, batch=n, seq=prompt_len, d_model=cfg.d_model,
                         n_patches=PATCHES)
    prompts = rng.integers(0, cfg.vocab, size=(n, prompt_len)).astype(np.int32)
    if same_prompt:
        prompts[:] = prompts[0]
    return [cls(rid=i, prompt=prompts[i].copy(), max_new=max_new,
                extras={k: v[i] for k, v in ex.items()} if extras else None)
            for i in range(n)]


def _run_port(models, reqs, **kw):
    cfg, params = models["torch32"]
    kw.setdefault("slots", 3)
    kw.setdefault("max_len", 48)
    eng = ServingEngine(cfg, block_size=8, params=params, device="cpu", **kw)
    summary = eng.run(reqs)
    return token_streams(reqs), summary


def _run_jax(models, reqs, **kw):
    kw.setdefault("slots", 3)
    return run_workload(*models["jax32"], requests=reqs, **kw)


def test_extras_survive_recompute_preemption(models):
    """The JAX suite's case: 5 vision requests of 16 + 24 tokens in a pool
    of 9 blocks (each needs 5) recompute-preempt; the replay's generated
    tail takes (t, t, t) ids, and the streams equal the unconstrained run's
    and the JAX engine's."""
    cfg = models["torch32"][0]
    full, _ = _run_port(models, _requests(cfg, 5), n_blocks=18)
    tight, summary = _run_port(models, _requests(cfg, 5), n_blocks=9)
    assert summary["preemptions"]["recompute"] > 0
    assert tight == full
    theirs, jsummary = _run_jax(models, _requests(cfg, 5, cls=JaxRequest), n_blocks=9)
    assert tight == theirs
    assert summary["preemptions"] == jsummary["preemptions"]


def test_different_patches_share_no_prefix(models):
    """Three requests with one prompt and different patch embeddings: the
    prefix cache skips them (their KV is not a function of the tokens), so
    no token is a prefix hit; the streams equal the JAX engine's."""
    cfg = models["torch32"][0]
    ours, summary = _run_port(models, _requests(cfg, 3, max_new=4, same_prompt=True))
    assert summary["prefix"]["hit_tokens"] == 0
    assert len({tuple(map(tuple, s)) for s in ours.values()}) > 1
    theirs, _ = _run_jax(models, _requests(cfg, 3, max_new=4, same_prompt=True,
                                           cls=JaxRequest))
    assert ours == theirs


def test_extras_past_the_chunk_refused_at_submit(models):
    cfg, params = models["torch32"]
    eng = ServingEngine(cfg, slots=2, max_len=48, block_size=8, params=params,
                        device="cpu", prefill_chunk=16)
    ok, = _requests(cfg, 1, max_new=1)                  # replay 16 = the chunk
    eng.submit(ok)
    long, = _requests(cfg, 1, max_new=2)                # worst replay 17
    with pytest.raises(ValueError, match="one prefill chunk"):
        eng.submit(long)
    text, = _requests(cfg, 1, max_new=8, extras=False)  # no extras: chunked
    text.rid = 1
    eng.submit(text)


def test_text_only_requests_alone_take_mixed_dispatch(models):
    """Three text-only and three vision requests together: the text-only
    prompts are staged through mixed dispatches, the vision prompts take the
    separate one-chunk prefill; streams equal the JAX engine's."""
    cfg = models["torch32"][0]

    def reqs(cls):
        text = _requests(cfg, 3, max_new=12, extras=False, seed=1, cls=cls)
        vision = _requests(cfg, 3, max_new=12, seed=2, cls=cls)
        for i, r in enumerate(vision):
            r.rid = 3 + i
        return [r for pair in zip(text, vision) for r in pair]

    staged, prefilled = [], []
    cls = ServingEngine

    class Recording(cls):
        def _stage_mixed_admission(self, req, grant=None):
            staged.append(req.rid)
            return super()._stage_mixed_admission(req, grant)

        def _prefill_request(self, req, now, grant=None):
            prefilled.append(req.rid)
            return super()._prefill_request(req, now, grant)

    tcfg, params = models["torch32"]
    eng = Recording(tcfg, slots=3, max_len=48, block_size=8, params=params, device="cpu")
    ours_reqs = reqs(Request)
    summary = eng.run(ours_reqs)
    assert eng.mixed and summary["mixed"]["dispatches"] > 0
    assert sorted(staged) == [0, 1, 2] and sorted(prefilled) == [3, 4, 5]
    theirs, _ = _run_jax(models, reqs(JaxRequest))
    assert token_streams(ours_reqs) == theirs


def _jax_static_loop(cfg, params, batch, gen):
    prefill = jax.jit(jsteps.make_prefill_step(cfg, max_len=batch["tokens"].shape[1] + gen))
    decode = jax.jit(jsteps.make_decode_step(cfg))
    last, caches = prefill(params, {k: jnp.asarray(v) for k, v in batch.items()})
    tok = jnp.argmax(last, axis=-1).astype(jnp.int32)[:, None]
    outs = []
    for _ in range(gen):
        outs.append(tok)
        tok, caches = decode(params, caches, tok)
    return np.asarray(jnp.concatenate(outs, axis=-1))


def test_static_loop_with_extras_equals_engine_and_jax(models):
    """``serve_static`` feeds the requests' extras to its prefill: its
    tokens equal ``serve``'s on the same requests and the JAX static loop's
    on the same batch."""
    tcfg, tparams = models["torch32"]
    batch, prompt_len, gen = 3, 16, 6
    reqs = tserve._batch_requests(tcfg, batch, prompt_len, gen, 0)
    assert all(r.extras["patch_embeds"].shape == (4, tcfg.d_model) for r in reqs)
    static, _ = tserve.serve_static(tcfg, batch=batch, prompt_len=prompt_len, gen=gen,
                                    params=tparams, device="cpu", verbose=False)
    engine, _ = tserve.serve(tcfg, batch=batch, prompt_len=prompt_len, gen=gen,
                             params=tparams, device="cpu", verbose=False)
    np.testing.assert_array_equal(static, engine)
    data = {"tokens": np.stack([r.prompt for r in reqs]),
            "patch_embeds": np.stack([r.extras["patch_embeds"] for r in reqs]),
            "pos3d": np.stack([r.extras["pos3d"] for r in reqs])}
    np.testing.assert_array_equal(static, _jax_static_loop(*models["jax32"], data, gen))


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "musicgen-medium"])
def test_serve_cli(arch, capsys):
    tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                 "--prompt-len", "8", "--gen", "3"])
    tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                 "--prompt-len", "8", "--gen", "3", "--static"])
    out = capsys.readouterr().out.splitlines()
    firsts = [line for line in out if "first request tokens" in line]
    assert len(firsts) == 2 and firsts[0] == firsts[1]
