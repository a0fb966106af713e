"""The chunk-attention kernel (``kernels/chunk_attn``) and its plain
version.

CPU: the plain version (``chunk_attn_ref``, the reference the card's kernel
is held to) against ``nn/attention.py _gather_attend``, the core the port
runs wherever the kernel does not: equal bit for bit on every real row that
sees a key, exactly 0 on pad rows and idle slots, over G ∈ {1, 3, 16}, D ∈
{64, 128}, window 0 and 8, bf16 and int8 pools, in a tile that holds a
prefill chunk crossing page boundaries, a decode row, an idle slot and a
slot without pad rows.  The plain version's real rows against the JAX
package's ``_paged_gqa_core`` on the same pools, tables and q_lens.  What
:func:`covers` takes, and the CPU core kept on ``_gather_attend``.

Card (``-m card`` on a machine with one; skipped here): the kernel against
the plain float32 gather + softmax at rag's and chat's mixed tiles, an int8
pool and a windowed D = 64 case; a real row's bits independent of its tile;
a shape the kernel does not take running the gather core; one mixed forward
of phi4 (2 layers) launching the kernel once a layer and never the gather
core; greedy tokens equal with mixed dispatch on and off.  The card's
machine runs no JAX: the kernel meets the JAX package through the plain
version, which the CPU tests hold to it.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.chunk_attn import chunk_attn, chunk_attn_ref, covers, takes
from repro_torch.kernels.chunk_attn.ops import launch_plan
from repro_torch.nn import attention as tattn

KV_SCALE = tattn.KV_SCALE


def _pools(rng, n, bs, hkv, d, int8):
    if int8:
        return [torch.from_numpy(rng.integers(-127, 128, (n, bs, hkv, d)).astype(np.int8))
                for _ in range(2)]
    return [torch.from_numpy(rng.normal(size=(n, bs, hkv, d)).astype(np.float32)).bfloat16()
            for _ in range(2)]


def _tile(G, D, int8, seed=0):
    """Four slots of an S = 6 tile over bs = 4, P = 5: slot 0 a 4-row chunk
    at positions 5–8 (two pad rows; it crosses the page boundary at 8), slot
    1 a decode row at 12, slot 2 idle, slot 3 six rows at 3–8."""
    rng = np.random.default_rng(seed)
    B, S, HKV, BS, P = 4, 6, 2, 4, 5
    N = B * P + 1
    q = torch.from_numpy(rng.normal(size=(B, S, HKV * G, D)).astype(np.float32)).bfloat16()
    kp, vp = _pools(rng, N, BS, HKV, D, int8)
    tables = torch.from_numpy(rng.permutation(N - 1)[:B * P].reshape(B, P).astype(np.int32))
    q_lens = torch.tensor([4, 1, 0, 6], dtype=torch.int32)
    lengths = torch.tensor([5, 12, 7, 3], dtype=torch.int32) + q_lens
    return q, kp, vp, tables, lengths, q_lens


def _positions(lengths, S):
    return lengths[:, None] - S + torch.arange(S, dtype=torch.int32)[None]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 3, 16])
def test_plain_matches_gather_attend(G, D, window, int8):
    q, kp, vp, tables, lengths, q_lens = _tile(G, D, int8, seed=G * D + window)
    S = q.shape[1]
    scale = KV_SCALE if int8 else None
    got = chunk_attn_ref(q, kp, vp, tables, lengths, q_lens, window=window, kv_scale=scale)
    assert got.dtype == q.dtype and got.shape == q.shape
    want = tattn._gather_attend(q, kp, vp, tables, _positions(lengths, S), lengths, window)
    real = torch.arange(S)[None] >= (S - q_lens)[:, None]
    assert torch.equal(got[real], want[real])
    assert torch.count_nonzero(got[~real]) == 0          # pad rows and the idle slot
    assert torch.count_nonzero(got[2]) == 0


@pytest.mark.parametrize("G", [1, 3, 16])
def test_plain_prefill_without_q_lens(G):
    """Plain chunked prefill (every row real): the same numbers as the gather
    core, and as the mixed tile's rows of a slot whose q_lens is S."""
    q, kp, vp, tables, lengths, _ = _tile(G, 64, False, seed=G)
    S = q.shape[1]
    got = chunk_attn_ref(q, kp, vp, tables, lengths)
    assert torch.equal(got, tattn._gather_attend(q, kp, vp, tables, _positions(lengths, S),
                                                 lengths, 0))
    full = torch.full_like(lengths, S)
    assert torch.equal(got, chunk_attn_ref(q, kp, vp, tables, lengths, full))


JAX_CASES = [  # (q and pool dtype, G, D, window)
    ("float32", 3, 64, 0), ("bfloat16", 16, 128, 8), ("int8", 1, 64, 0), ("int8", 3, 128, 8),
]


@pytest.mark.parametrize("kind,G,D,window", JAX_CASES)
def test_plain_matches_jax_core(kind, G, D, window):
    """The plain version's real rows against the JAX package's
    ``_paged_gqa_core`` (its jnp gather + sdpa, inline there) on the same
    mixed tile: JAX writes the tile's K/V rows into the pools, and the plain
    version attends over the pools JAX returns.  float32: within the paged
    core's port bound (3e-5, ``test_torch_attention.py``); bf16 q (over a bf16
    or int8 pool): both round a float32 result once to bf16, and the float32
    sums' orders differ, so a row may part by one bf16 step (2^-7 relative)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.configs.base import AttnConfig as JAttnConfig
    from repro.nn import attention as jattn

    int8 = kind == "int8"
    q, kp, vp, tables, lengths, q_lens = _tile(G, D, int8, seed=7 * G + D + window)
    B, S, H, _ = q.shape
    pos = lengths - q_lens
    rng = np.random.default_rng(G + D)
    k, v = (rng.normal(size=(B, S, H // G, D)).astype(np.float32) for _ in range(2))
    qdt, jdt = (torch.float32, jnp.float32) if kind == "float32" else (torch.bfloat16,
                                                                          jnp.bfloat16)
    q = q.to(qdt)
    if not int8:
        kp, vp = kp.to(qdt), vp.to(qdt)
    j = lambda t: jnp.asarray(t.float().numpy()).astype(jdt) if t.is_floating_point() \
        else jnp.asarray(t.numpy())
    jk, jv = (jnp.asarray(x).astype(jdt) for x in (k, v))
    cfg = JAttnConfig(kind="gqa", n_heads=H, n_kv_heads=H // G, d_head=D, window=window)
    jo, jc = jattn._paged_gqa_core(j(q), jk, jv, cfg, j(_positions(lengths, S)),
                                   {"k_pool": j(kp), "v_pool": j(vp), "pos": j(pos)},
                                   j(tables), q_lens=j(q_lens))
    pools = [torch.from_numpy(np.array(jc[n]).astype(np.int8 if int8 else np.float32))
             for n in ("k_pool", "v_pool")]
    if not int8:
        pools = [t.to(qdt) for t in pools]
    got = chunk_attn_ref(q, *pools, tables, lengths, q_lens, window=window,
                         kv_scale=KV_SCALE if int8 else None).float()
    want = torch.from_numpy(np.array(jo.astype(jnp.float32)))
    real = torch.arange(S)[None] >= (S - q_lens)[:, None]
    g, w = got[real], want[real]
    if kind == "float32":
        torch.testing.assert_close(g, w, atol=3e-5, rtol=1e-4)
    else:
        assert torch.all((g - w).abs() <= w.abs() * 2.0 ** -7 + 1e-6), \
            f"max abs err {(g - w).abs().max().item()}"


def test_row_past_every_key_gives_zero():
    """A real row whose window holds no written key (positions past the
    table's span) gives 0, as the kernel does, where the gather core would
    average every masked key."""
    q, kp, vp, tables, _, _ = _tile(3, 64, False)
    P, bs = tables.shape[1], kp.shape[1]
    lengths = torch.full((4,), P * bs + 8, dtype=torch.int32)
    got = chunk_attn_ref(q, kp, vp, tables, lengths, window=2)
    assert torch.count_nonzero(got) == 0


def test_covers_and_plan():
    q = torch.zeros(1, 2, 4, 64, dtype=torch.bfloat16)
    pool = torch.zeros(3, 16, 2, 64, dtype=torch.bfloat16)
    assert not covers(q, pool)                            # the CPU keeps the plain core
    assert takes(q, pool) and takes(q, pool.to(torch.int8))
    assert takes(q, torch.zeros(3, 64, 2, 64, dtype=torch.bfloat16))
    refused = [(q.float(), pool), (q, pool.float()),      # a float32 q or pool
               (torch.zeros(1, 2, 4, 96, dtype=torch.bfloat16),
                torch.zeros(3, 16, 2, 96, dtype=torch.bfloat16)),   # D = 96
               (q, torch.zeros(3, 24, 2, 64, dtype=torch.bfloat16)),   # bs 24: not 64's divisor
               (q, torch.zeros(3, 128, 2, 64, dtype=torch.bfloat16)),  # bs 128
               (q, torch.zeros(3, 16, 3, 64, dtype=torch.bfloat16))]   # 4 heads over 3
    assert not any(takes(a, b) for a, b in refused)
    for D in (64, 128):
        for elt in (1, 2):
            plan = launch_plan(16, 512, 8, 3, D, elt, 132)
            assert 2 * (plan["smem"] + 1024) <= 228 * 1024  # two CTAs an SM
            assert plan["items"] == 24 * 16 * 8 and plan["ctas"] == 264
    assert launch_plan(16, 128, 4, 16, 128, 2, 132)["items"] == 32 * 16 * 4
    assert launch_plan(1, 2, 1, 1, 64, 2, 132)["ctas"] == 1


def test_kernel_entry_refuses_cpu():
    """The kernel's entry launches or raises: CPU tensors raise, with no
    plain version behind it and no launch counted."""
    q, kp, vp, tables, lengths, q_lens = _tile(3, 64, False)
    before = chunk_attn.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        chunk_attn(q, kp, vp, tables, lengths, q_lens)
    assert chunk_attn.launches == before


def test_cpu_core_keeps_gather_attend(monkeypatch):
    """On the CPU the paged core runs ``_gather_attend`` for chunked prefill
    and the mixed tile, and never launches the kernel."""
    calls = []
    real = tattn._gather_attend
    monkeypatch.setattr(tattn, "_gather_attend", lambda *a: calls.append(1) or real(*a))
    q, kp, vp, tables, lengths, q_lens = _tile(3, 64, False)
    cfg = tattn.AttnConfig(n_heads=6, n_kv_heads=2, d_head=64)
    B, S = q.shape[:2]
    k = torch.zeros(B, S, 2, 64, dtype=torch.bfloat16)
    pos = lengths - q_lens
    before = chunk_attn.launches
    cache = {"k_pool": kp, "v_pool": vp, "pos": pos}
    tattn._paged_gqa_core(q, k, k, cfg, _positions(lengths, S), cache, tables, q_lens=q_lens)
    assert calls == [1] and chunk_attn.launches == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def serving_tile(B, S, P, bs, H, Hkv, D, *, int8=False, chunk_pos=1024, seed=0,
                 device="cuda"):
    """A mixed tile as the engine builds it: slot 0 carries a full S-row
    prompt chunk at ``chunk_pos``, slots 1 … B − 3 a decode row each at
    lengths spread over the table, the last two slots idle; pools of
    ``B·P + 1`` blocks, each slot's table a random permutation."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    N = B * P + 1
    q = torch.randn(B, S, H, D, generator=g).bfloat16()
    if int8:
        kp, vp = (torch.randint(-127, 128, (N, bs, Hkv, D), generator=g, dtype=torch.int8)
                  for _ in range(2))
    else:
        kp, vp = (torch.randn(N, bs, Hkv, D, generator=g).bfloat16() for _ in range(2))
    tables = torch.randperm(N - 1, generator=g)[:B * P].reshape(B, P).int()
    q_lens = torch.ones(B, dtype=torch.int32)
    q_lens[0], q_lens[-2:] = S, 0
    pos = torch.randint(S, P * bs - S, (B,), generator=g, dtype=torch.int32)
    pos[0] = chunk_pos
    lengths = pos + q_lens
    return [t.to(device) for t in (q, kp, vp, tables, lengths, q_lens)]


def _close_to_plain(got, want, v_max):
    """Kernel vs the float32 plain core, both rounded once to bf16 at the
    end.  Before the rounding they part by P's split (hi + lo is P to 2^-16
    relative, so Σ P·V moves by at most 2^-16·max|V|, which a sum that
    cancels does not shrink) and by the order of the float32 sums: atol is
    2^-15·max|V|, twice the split's bound.  The rounding then adds one bf16
    step at most, 2^-7·|x|."""
    g, w = got.float(), want.float()
    assert torch.all((g - w).abs() <= w.abs() * 2.0 ** -7 + 2.0 ** -15 * v_max), \
        f"max abs err {(g - w).abs().max().item()}"


CARD_CASES = {
    "rag": dict(B=16, S=512, P=132, bs=16, H=24, Hkv=8, D=128),
    "chat": dict(B=16, S=128, P=128, bs=16, H=64, Hkv=4, D=128),
    "rag_int8": dict(B=16, S=512, P=132, bs=16, H=24, Hkv=8, D=128, int8=True),
    "hymba_window_d64": dict(B=4, S=256, P=64, bs=16, H=25, Hkv=5, D=64, window=300),
}


@pytest.mark.card
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_kernel_matches_plain_card(card, case):
    kw = dict(CARD_CASES[case])
    window = kw.pop("window", 0)
    q, kp, vp, tables, lengths, q_lens = serving_tile(**kw)
    scale = KV_SCALE if kp.dtype == torch.int8 else None
    got = chunk_attn(q, kp, vp, tables, lengths, q_lens, window=window, kv_scale=scale)
    want = chunk_attn_ref(q, kp, vp, tables, lengths, q_lens, window=window, kv_scale=scale)
    torch.cuda.synchronize()
    v_max = vp.float().abs().max().item() / (scale or 1.0)
    _close_to_plain(got, want, v_max)
    assert torch.count_nonzero(got[-2:]) == 0             # idle slots give exactly 0


@pytest.mark.card
def test_uncovered_shape_takes_gather_card(card, monkeypatch):
    """A bf16 model on the card whose pool has a block size the kernel does
    not take (24, which ``paged_attention`` does) runs the gather core, as
    before the kernel, and launches nothing; the kernel's entry raises."""
    calls = []
    real = tattn._gather_attend
    monkeypatch.setattr(tattn, "_gather_attend", lambda *a: calls.append(1) or real(*a))
    q, kp, vp, tables, lengths, q_lens = serving_tile(4, 64, 8, 24, 6, 2, 128, chunk_pos=64)
    assert not covers(q, kp)
    S = q.shape[1]
    positions = lengths[:, None] - S + torch.arange(S, device="cuda", dtype=torch.int32)[None]
    before = chunk_attn.launches
    out = tattn._chunk_core(q, kp, vp, tables, positions, lengths, q_lens, 0, None)
    torch.cuda.synchronize()
    assert calls == [1] and chunk_attn.launches == before and out.shape == q.shape
    with pytest.raises(ValueError, match="not a case the kernel takes"):
        chunk_attn(q, kp, vp, tables, lengths, q_lens)


@pytest.mark.card
def test_kernel_rows_independent_of_tile_card(card):
    """Slot 0's chunk as the mixed tile's rows (with 15 other slots and pad
    rows around it) and as a chunked prefill of its own ([1, S], no q_lens)
    give the same bits, row for row, at a chunk that does not start on a
    64-key block."""
    q, kp, vp, tables, lengths, q_lens = serving_tile(16, 512, 132, 16, 24, 8, 128,
                                                      chunk_pos=1000)
    q_lens[0] = 300                                      # 212 pad rows first
    tile = chunk_attn(q, kp, vp, tables, lengths, q_lens)
    alone = chunk_attn(q[:1, -300:].contiguous(), kp, vp, tables[:1], lengths[:1])
    assert torch.equal(tile[0, -300:], alone[0])


def _phi4_2_layers():
    from repro_torch.models import registry
    cfg = registry.get_config("phi4-mini-3.8b")
    return cfg.with_overrides(blocks=tuple(dataclasses.replace(b, n_layers=2)
                                           for b in cfg.blocks))


@pytest.mark.card
def test_mixed_forward_launches_kernel_card(card, monkeypatch):
    from repro_torch.launch.steps import init_serving_caches, make_serving_mixed_step
    from repro_torch.models import lm
    from repro_torch.nn.module import materialize

    cfg = _phi4_2_layers()
    params = materialize(lm.param_spec(cfg), torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    B, Q, bs, max_len = 4, 64, 16, 256
    caches = init_serving_caches(cfg, B, max_len, device="cuda", n_blocks=B * max_len // bs,
                                 block_size=bs)
    tables = torch.arange(B * max_len // bs, device="cuda", dtype=torch.int32).reshape(B, -1)
    gathers = []
    real = tattn._gather_attend
    monkeypatch.setattr(tattn, "_gather_attend", lambda *a: gathers.append(1) or real(*a))
    step = make_serving_mixed_step(cfg)
    tokens = torch.randint(0, cfg.vocab, (B, Q), device="cuda", dtype=torch.int32)
    lengths = torch.tensor([0, 40, 70, 0], device="cuda", dtype=torch.int32)
    q_lens = torch.tensor([Q, 1, 1, 0], device="cuda", dtype=torch.int32)
    decode = torch.tensor([False, True, True, False], device="cuda")
    active = torch.tensor([True, True, True, False], device="cuda")
    before = chunk_attn.launches
    with torch.no_grad():
        nxt, _, _ = step(params, caches, tokens, lengths, q_lens, decode, active, tables)
    torch.cuda.synchronize()
    assert chunk_attn.launches - before == cfg.n_layers
    assert not gathers
    assert nxt.shape[0] == B


@pytest.mark.card
def test_mixed_on_off_greedy_tokens_card(card):
    """One prompt of two full chunks, 24 greedy tokens: the mixed tile and the
    separate prefill dispatch run the same products at the same shapes, and
    the chunk kernel's rows do not depend on the tile, so the tokens agree."""
    from repro_torch.models import lm
    from repro_torch.nn.module import materialize
    from repro_torch.serving import Request, ServingEngine

    cfg = _phi4_2_layers()
    params = materialize(lm.param_spec(cfg), torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, 128, dtype=np.int32)
    streams, mixed = {}, {}
    for on in (True, False):
        eng = ServingEngine(cfg, slots=1, max_len=256, block_size=16, params=params,
                            device="cuda", prefill_chunk=64, mixed=on)
        req = Request(rid=0, prompt=prompt, max_new=24)
        mixed[on] = eng.run([req])["mixed"]["dispatches"]
        streams[on] = [int(np.ravel(t)[0]) for t in req.generated]
    assert mixed[True] > 0 and mixed[False] == 0
    assert streams[True] == streams[False] and len(streams[True]) == 24
