"""n-gram self-speculative decoding of the port against the JAX package,
phi4-mini smoke.

The JAX package's float32 params cross through the bridge and both sides run
float32 KV pools.  ``ngram_propose`` and one ``make_serving_spec_horizon``
dispatch hold bit for bit on the same numpy inputs (tokens, counts, history
ring, ``pos``), including a verify tile that crosses a block boundary, a slot
at its ``remaining`` budget and an EOS inside the tile.  Then the engines:
the port's greedy streams and speculation counters equal the JAX engine's in
every case of ``tests/test_serving.py``'s speculation family, the port's
spec-on streams equal its spec-off streams, and the draft history stays
aligned across plain-step fallbacks.  JAX engine runs are shared through
module-scoped fixtures."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from serving_harness import materialize, mixed_spec, run_workload, token_streams
from test_torch_engine import run_port

from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.serving import SCENARIOS as JAX_SCENARIOS
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.launch import steps as tsteps
from repro_torch.models import registry as tregistry
from repro_torch.serving import Request, ServingEngine

ARCH = "phi4-mini-3.8b"
SHARED = mixed_spec(n_requests=6, shared_prefix=24, prompt_buckets=(8, 16),
                    gen_buckets=(4, 16))
REPETITIVE = dataclasses.replace(JAX_SCENARIOS["repetitive"], n_requests=4,
                                 rate=1e9, gen_buckets=(96,))
REP_KW = {"spec": REPETITIVE, "slots": 3, "max_len": 144, "block_size": 16,
          "horizon": 4}
# the engine cases of tests/test_serving.py's speculation family; each
# "off" twin is the same run with speculation off
CASES = {
    "k2": {"spec_ngram": 2},
    "k4": {"spec_ngram": 4},
    "k2_h8": {"spec_ngram": 2, "horizon": 8},
    "k2_h8_jit_cache1": {"spec_ngram": 2, "horizon": 8, "jit_cache": 1},
    "k4_swap": {"spec_ngram": 4, "n_blocks": 8, "swap_blocks": 32},
    "k4_recompute": {"spec_ngram": 4, "n_blocks": 8},
    "k4_shared": {"spec_ngram": 4, "spec": SHARED, "max_len": 64},
    "k4_shared_swap": {"spec_ngram": 4, "spec": SHARED, "max_len": 64,
                       "n_blocks": 12, "swap_blocks": 32},
    "k4_repetitive": {"spec_ngram": 4, **REP_KW},
}
OFF = {"off": {}, "off_shared": {"spec": SHARED, "max_len": 64,
                                 "prefix_sharing": False},
       "off_repetitive": REP_KW}


@pytest.fixture(scope="module")
def models():
    jcfg, jparams = materialize(ARCH)
    host = jax.tree.map(np.asarray, jparams)
    return {"jax32": (jcfg.with_overrides(kv_dtype="float32"),
                      jax.tree.map(lambda a: a.astype(np.float32), jparams)),
            "torch32": (tregistry.get_smoke(ARCH).with_overrides(kv_dtype="float32"),
                        params_from_numpy(host, "cpu", dtype=torch.float32))}


@pytest.fixture(scope="module")
def runs(models):
    """Memoised engine runs: (package, case) → (streams, summary).  A case
    is a name of CASES or OFF, or a tuple of (key, value) pairs."""
    cache = {}

    def get(pkg, case):
        if (pkg, case) not in cache:
            kw = dict(CASES[case] if case in CASES else OFF[case] if case in OFF
                      else case)
            if pkg == "torch":
                streams, summary, _ = run_port(*models["torch32"], **kw)
            else:
                streams, summary = run_workload(*models["jax32"], **kw)
            cache[pkg, case] = (streams, summary)
        return cache[pkg, case]

    return get


# ---------------------------------------------------------------- the steps

def _hist_cases():
    rng = np.random.default_rng(5)
    hand = np.asarray([
        [-1, -1, 7, 8, 9, 1, 5, 7, 8],      # earlier (7, 8) → [9, 1]
        [-1, -1, -1, 1, 2, 3, 4, 5, 6],     # no match → repeat the last token
        [7, 8, 3, 7, 8, 5, 0, 7, 8],        # the most recent match wins
        [-1, -1, -1, -1, -1, -1, -1, 5, 5],  # a boundary draft clamps to >= 0
    ], np.int32)
    small = rng.integers(0, 4, size=(16, 24), dtype=np.int32)   # many matches
    small[:5, :7] = -1
    return {"hand": hand, "small_vocab": small,
            "wide": rng.integers(0, 50, size=(8, 64), dtype=np.int32)}


@pytest.mark.parametrize("K,n", [(2, 2), (4, 2), (3, 3), (1, 1)])
@pytest.mark.parametrize("which", ["hand", "small_vocab", "wide"])
def test_ngram_propose_bit_for_bit(which, K, n):
    hist = _hist_cases()[which]
    if hist.shape[1] - n - K + 1 < 1:
        with pytest.raises(ValueError, match="too short"):
            tsteps.ngram_propose(torch.from_numpy(hist), K, n)
        return
    ours = tsteps.ngram_propose(torch.from_numpy(hist), K, n)
    theirs = np.asarray(jsteps.ngram_propose(jnp.asarray(hist), K, n))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), theirs)
    if which == "hand" and (K, n) == (2, 2):
        np.testing.assert_array_equal(ours.numpy()[:3], [[9, 1], [6, 6], [5, 0]])


def test_ngram_propose_rejects_short_history():
    with pytest.raises(ValueError, match="too short"):
        tsteps.ngram_propose(torch.zeros((2, 5), dtype=torch.int32), 4, 2)


def test_speculable_matches_jax(models):
    (jcfg, _), (tcfg, _) = models["jax32"], models["torch32"]
    for over in ({}, {"n_codebooks": 2}):
        assert tsteps.speculable(tcfg.with_overrides(**over)) == \
            jsteps.speculable(jcfg.with_overrides(**over))
    assert tsteps.speculable(tcfg)
    assert not tsteps.speculable(tcfg.with_overrides(n_codebooks=2))


def _spec_dispatch_inputs(cfg, rng):
    """Four slots (one inactive) with repetitive prompts prefilled to
    lengths 14, 16 and 21: slot 0's first verify tile (rows 14-17 at K=3)
    crosses the block boundary at 16, slot 1 has a budget of 2 tokens."""
    B, bs, P, n_blocks, S = 4, 8, 6, 26, 21
    pat = rng.integers(0, cfg.vocab, size=(B, 5), dtype=np.int32)
    prompts = np.tile(pat, (1, 5))[:, :S]
    tables = rng.permutation(n_blocks)[:B * P].reshape(B, P).astype(np.int32)
    lengths = np.asarray([14, 16, 21, 9], np.int32)
    remaining = np.asarray([9, 2, 9, 9], np.int32)
    active = np.asarray([True, True, True, False])
    tokens = rng.integers(0, cfg.vocab, size=(B, 1), dtype=np.int32)
    W = 16
    hist = np.full((B, W), -1, np.int32)
    for s in range(B):
        ctx = np.concatenate([prompts[s, :lengths[s]], tokens[s]])[-W:]
        hist[s, W - len(ctx):] = ctx
    return dict(prompts=prompts, tables=tables, lengths=lengths,
                remaining=remaining, active=active, tokens=tokens, hist=hist,
                n_blocks=n_blocks, bs=bs, max_len=P * bs)


def test_spec_horizon_dispatch_bit_for_bit(models):
    """One fused dispatch of H=4 draft→verify→accept steps at K=3 on both
    packages from the same pool contents: equal token blocks, counts, last
    tokens, history rings and per-slot ``pos``; then again with an EOS id
    taken from that run (a slot meets EOS inside a tile)."""
    (jcfg, jparams), (tcfg, tparams) = models["jax32"], models["torch32"]
    d = _spec_dispatch_inputs(jcfg, np.random.default_rng(11))
    B = len(d["lengths"])
    jc = jsteps.init_serving_caches(jcfg, B, d["max_len"], block_size=d["bs"],
                                    n_blocks=d["n_blocks"])
    _, jc, _ = jax.jit(lambda p, c, t, tb: jlm.forward(p, t, jcfg, caches=c,
                                                       tables=tb))(
        jparams, jc, jnp.asarray(d["prompts"]), jnp.asarray(d["tables"]))
    # truncate each slot to its length: rows past it are stale and invisible
    for seg in jc:
        seg["attn"]["pos"] = jnp.broadcast_to(jnp.asarray(d["lengths"]),
                                              seg["attn"]["pos"].shape)
    host = [{k: np.asarray(v) for k, v in seg["attn"].items()} for seg in jc]
    jfn = jax.jit(jsteps.make_serving_spec_horizon(jcfg, 4, 3))
    tfn = tsteps.make_serving_spec_horizon(tcfg, 4, 3)
    blocks = {}
    for eos in (-1, None):
        if eos is None:                       # a token the first run emitted
            eos = int(blocks[-1][0][2, 1, 0])
        jc_run = [{"attn": {k: jnp.asarray(v) for k, v in seg.items()}} for seg in host]
        tc = [{"attn": {k: torch.from_numpy(v.copy()) for k, v in seg.items()}}
              for seg in host]
        theirs = jfn(jparams, jc_run, jnp.asarray(d["tokens"]),
                     jnp.asarray(d["lengths"]), jnp.asarray(d["active"]),
                     jnp.asarray(d["remaining"]), jnp.asarray(d["hist"]),
                     jnp.asarray(d["tables"]), jnp.int32(eos))
        ours = tfn(tparams, tc, torch.from_numpy(d["tokens"]),
                   torch.from_numpy(d["lengths"]), torch.from_numpy(d["active"]),
                   torch.from_numpy(d["remaining"]), torch.from_numpy(d["hist"]),
                   torch.from_numpy(d["tables"]), eos)
        for name, a, b in zip(("block", "counts", "last", "hist"), ours[:4], theirs[:4]):
            assert a.dtype == torch.int32, name
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        np.testing.assert_array_equal(ours[4][0]["attn"]["pos"].numpy(),
                                      np.asarray(theirs[4][0]["attn"]["pos"]))
        blocks[eos] = (ours[0].numpy(), ours[1].numpy())
    block, counts = blocks[-1]
    assert counts[3].sum() == 0                       # the inactive slot
    assert counts[1].sum() == 2                       # slot 1's budget
    assert counts[0, 0] >= 1 and counts[2].sum() > 0
    eos_counts = blocks[eos][1]
    assert eos_counts[2].sum() < counts[2].sum()      # slot 2 stopped at EOS


# ---------------------------------------------------------------- the engine

@pytest.mark.parametrize("case", list(CASES))
def test_spec_streams_and_counters_equal_jax_engine(runs, case):
    ours, s = runs("torch", case)
    theirs, js = runs("jax", case)
    assert ours == theirs
    assert s["speculation"] == js["speculation"]
    for key in ("decode_dispatches", "decode_steps", "generated_tokens",
                "jit_evictions", "preemptions"):
        assert s[key] == js[key], key
    assert s["speculation"]["drafted"] > 0
    if case in ("k4_swap", "k4_recompute"):
        assert s["preemptions"][case[3:]] > 0
    if case == "k4_shared_swap" and s["preemptions"]["swap"]:
        assert s["prefix"]["swap_skipped_blocks"] > 0
    if case == "k2_h8_jit_cache1":
        assert s["jit_evictions"] > 0
    if case == "k4_repetitive":
        assert s["speculation"]["accept_rate"] > 0.2


@pytest.mark.parametrize("case", list(CASES))
def test_spec_on_equals_spec_off_in_the_port(runs, case):
    kw = CASES[case]
    off = ("off_repetitive" if kw.get("spec") is REPETITIVE
           else "off_shared" if kw.get("spec") is SHARED else "off")
    on, s1 = runs("torch", case)
    base, s0 = runs("torch", off)
    assert on == base
    assert s1["decode_tokens"] == s0["decode_tokens"]
    if case in ("k2_h8", "k4_repetitive"):
        assert s1["decode_dispatches"] < s0["decode_dispatches"]
        assert s1["tokens_per_dispatch"] > s0["tokens_per_dispatch"]


def test_spec_eos_equals_jax_engine_and_spec_off(runs):
    """EOS inside an accepted run truncates where the plain engine stops."""
    base, _ = runs("jax", "off")
    rid = idx = eos = None
    for r, stream in sorted(base.items()):
        for i in range(2, len(stream) - 1):
            v = stream[i][0]
            if all(t[0] != v for t in stream[:i]):
                rid, idx, eos = r, i, v
                break
        if eos is not None:
            break
    on = (("eos_id", eos), ("spec_ngram", 4))
    ours, s = runs("torch", on)
    theirs, js = runs("jax", on)
    off, _ = runs("torch", (("eos_id", eos),))
    assert ours == theirs == off
    assert s["speculation"] == js["speculation"]
    assert len(ours[rid]) == idx + 1 and ours[rid][-1][0] == eos


def test_engine_rejects_sampling_and_a_short_history(models):
    cfg, params = models["torch32"]
    kw = dict(slots=2, max_len=32, block_size=8, params=params, device="cpu")
    with pytest.raises(ValueError, match="greedy"):
        ServingEngine(cfg, spec_ngram=2, temperature=0.7, **kw)
    with pytest.raises(ValueError, match="spec_hist"):
        ServingEngine(cfg, spec_ngram=4, spec_hist=5, **kw)
    with pytest.raises(ValueError, match="single-codebook"):
        ServingEngine(cfg.with_overrides(n_codebooks=2), spec_ngram=2, **kw)


def _drive_hist_case(eng, req_cls, check):
    """Step an engine over the history-alignment workload, calling
    ``check(eng)`` after every step; returns (streams, grants)."""
    grants = []
    orig = eng.sched.grant_horizon
    eng.sched.grant_horizon = lambda *a, **kw: grants.append(orig(*a, **kw)) or grants[-1]
    reqs = [req_cls(rid=i, prompt=np.arange(16, dtype=np.int32) + i, max_new=20)
            for i in range(3)]
    for r in reqs:
        eng.submit(r)
    guard = 0
    while eng.sched.has_work:
        eng.step()
        check(eng)
        guard += 1
        assert guard < 400
    return token_streams(reqs), grants


def test_spec_history_stays_aligned_including_fallback(models):
    """The port's draft history tracks prompt + generated exactly after every
    step, plain-step fallbacks included (7 blocks over 2 slots: spec grants
    intermittently fail), and its streams and grants equal the JAX engine's."""
    kw = dict(slots=2, max_len=48, block_size=8, spec_ngram=3, spec_hist=16,
              n_blocks=7)

    def aligned(eng):
        for slot, req in eng.sched.running.items():
            ctx = np.concatenate([np.asarray(req.replay_tokens()).ravel(),
                                  np.ravel(req.generated[-1])])
            row = np.asarray(eng._hist[slot])
            n = min(len(ctx), len(row))
            np.testing.assert_array_equal(row[-n:], ctx[-n:].astype(np.int32))

    ours, grants = _drive_hist_case(
        ServingEngine(models["torch32"][0], params=models["torch32"][1],
                      device="cpu", **kw), Request, aligned)
    theirs, jgrants = _drive_hist_case(
        JaxServingEngine(models["jax32"][0], params=models["jax32"][1], **kw),
        JaxRequest, lambda eng: None)
    assert 0 in grants and any(g >= 1 for g in grants)
    assert grants == jgrants
    assert ours == theirs


def test_spec_rollback_never_below_committed_length(models):
    """Per-slot lengths advance by the accepted count only: a slot's length
    never decreases while one request holds it, never grows past h·(K+1) a
    dispatch, and stays covered by its block table."""
    cfg, params = models["torch32"]
    K, H = 3, 4
    eng = ServingEngine(cfg, slots=3, max_len=48, block_size=8, params=params,
                        device="cpu", spec_ngram=K, horizon=H)
    pat = np.random.default_rng(0).integers(0, cfg.vocab, 4, dtype=np.int32)
    reqs = [Request(rid=i, prompt=np.tile(pat, 3), max_new=24) for i in range(4)]
    for r in reqs:
        eng.submit(r)
    guard = 0
    while eng.sched.has_work:
        before = dict(eng.sched.running)
        len_before = eng._slot_len.copy()
        eng.step()
        for s, req in before.items():
            if eng.sched.running.get(s) is req and req.slot == s:
                grew = int(eng._slot_len[s]) - int(len_before[s])
                assert 0 <= grew <= H * (K + 1)
                assert len(req.block_table) * 8 >= req.cached_len
        guard += 1
        assert guard < 500
    assert all(r.n_generated == 24 for r in reqs)
    assert eng.stats.spec_accepted > 0
