"""Step functions: the train step, the static loop and continuous batching.

The single-device subset of the JAX package's ``launch/steps.py``: the
train step (``make_train_step``: gradient accumulation over microbatches,
AdamW, the warmup-cosine ``lr_schedule``), the static loop's prefill and
decode over dense caches, and the continuous-batching
steps over the paged KV pool and the dense per-slot caches — slot prefill,
activity-masked decode, the guarded decode with its NaN verdict, the fused
mixed prefill+decode tile, the decode horizon and n-gram self-speculative
decode.  Each ``make_*`` returns a plain function that runs eagerly on the
caches' device; the horizons' ``lax.scan`` is a Python loop whose carry
stays on the device (one host sync per horizon, taken by the engine).

Every forward here routes MoE blocks drop-free (``moe_no_drop=True``), as
the JAX steps do: a token's experts never depend on what shares its batch.
Pool leaves are updated in place; every per-slot leaf (``pos``, dense K/V
rows, recurrent state) comes out of the forward as a new tensor and is
merged with the activity mask, as the JAX steps merge their functional
caches.  Sampling draws from a ``torch.Generator`` seeded per dispatch, so
sampled streams are deterministic for a seed but differ from
``jax.random``'s.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from repro_torch.configs.base import BlockConfig, ModelConfig
from repro_torch.models import lm
from repro_torch.nn.attention import POOL_LEAVES, init_paged_cache
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.tree import leaves_with_path, map_with_name, tree_map

__all__ = [
    "lr_schedule",
    "loss_and_grads",
    "make_train_step",
    "make_prefill_step",
    "make_decode_step",
    "pageable_block",
    "init_serving_caches",
    "make_slot_prefill_step",
    "make_serving_decode_step",
    "make_serving_decode_guarded",
    "make_serving_mixed_step",
    "make_serving_decode_horizon",
    "speculable",
    "ngram_propose",
    "make_serving_spec_horizon",
]


def pageable_block(b: BlockConfig) -> bool:
    """Whether a segment's attention cache can use the paged block pool
    (non-windowed GQA)."""
    return (b.kind in ("dense", "moe", "hymba") and b.attn is not None
            and b.attn.kind == "gqa" and b.attn.window == 0)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def lr_schedule(step: torch.Tensor, base: float = 3e-4, warmup: int = 100,
                total: int = 10_000) -> torch.Tensor:
    """Linear warmup to ``base`` (step 0 trains at base/warmup, not 0), then a
    cosine down to a tenth of it at ``total``; float32 on ``step``'s device."""
    s = step.to(torch.float32)
    warm = (s + 1.0) / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return base * torch.where(s < warmup, warm, 0.1 + 0.9 * cos)


def loss_and_grads(params, batch, cfg: ModelConfig):
    """(loss, metrics, grads) of ``lm.loss_fn`` at ``params``: ``grads`` has
    the params' tree and dtypes, zeros for a leaf the loss does not read
    (DeepSeek's ``route_bias``).  The params are not modified and get no
    ``.grad``."""
    leaves = [t for _, _, t in leaves_with_path(params)]
    live = [t.detach().requires_grad_(True) for t in leaves]
    it = iter(live)
    loss, metrics = lm.loss_fn(tree_map(lambda _: next(it), params), batch, cfg)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(t) for g, t in zip(grads, leaves))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        tree_map(lambda _: next(it), params)


def _sum_squares(g: torch.Tensor) -> torch.Tensor:
    """Σ g² in float32, blocks of whole trailing-axis rows at a time (the
    AdamW update's blocks), so no float32 copy of a whole bf16 leaf is
    made."""
    rows = g.reshape(-1, g.shape[-1] if g.dim() else 1)
    step = max(1, adamw.BLOCK_ELEMS // rows.shape[1])
    return sum(torch.sum(torch.square(rows[i:i + step].to(torch.float32)))
               for i in range(0, rows.shape[0], step))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                    accum: int = 1, base_lr: float = 3e-4, grad_shardings=None,
                    accum_dtype=torch.float32, warmup: int = 100) -> Callable:
    """(params, opt_state, batch) → (params, opt_state, metrics).

    ``batch`` leaves are [B, ...] when ``accum == 1``, else [accum,
    B/accum, ...]: a Python loop over the microbatches sums their gradients
    in ``accum_dtype`` and takes the mean.  The update is AdamW in place
    (``adamw_update_``), so the returned params and state are the ones
    passed in, updated.  Metrics: ``loss`` (the microbatches' mean of the
    total loss), ``grad_norm`` (the float32 sum of squares over every leaf,
    square-rooted) and ``lr``.  ``grad_shardings`` is accepted for the
    reference's signature; on one device there is nothing to pin."""
    del grad_shardings

    def train_step(params, opt_state, batch):
        if accum == 1:
            loss, _, grads = loss_and_grads(params, batch, cfg)
        else:
            grads, loss = None, 0.0
            for j in range(accum):
                l, _, g = loss_and_grads(params, {k: v[j] for k, v in batch.items()}, cfg)
                g = tree_map(lambda b: b.to(accum_dtype), g)
                grads = g if grads is None else tree_map(
                    lambda a, b: (a + b).to(accum_dtype), grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g.to(torch.float32) / accum, grads)
            loss = loss / accum
        lr = lr_schedule(opt_state["step"], base_lr, warmup=warmup)
        gnorm = torch.sqrt(sum(_sum_squares(g) for _, _, g in leaves_with_path(grads)))
        params, opt_state = adamw.adamw_update_(grads, params, opt_state, lr, opt_cfg)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step


# ---------------------------------------------------------------------------
# the static loop (dense caches, every row in lockstep)
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig, max_len: int) -> Callable:
    """(params, batch) → (last_logits [B,V] or [B,K,V], caches): fresh dense
    caches of ``max_len`` rows (scalar ``pos``; a ring of exactly ``window``
    rows for a windowed layer) filled by one forward over
    ``batch["tokens"]`` ([B,S] or [B,K,S]), with the vision stub's
    ``patch_embeds`` and ``pos3d`` when the batch carries them."""

    def prefill_step(params, batch):
        tokens = batch["tokens"]
        caches = lm.init_caches(cfg, tokens.shape[0], max_len, device=tokens.device)
        logits, caches, _ = lm.forward(params, tokens, cfg, caches=caches,
                                       patch_embeds=batch.get("patch_embeds"),
                                       pos3d=batch.get("pos3d"))
        return logits[:, -1], caches

    return prefill_step


def _cache_start(caches):
    """Absolute position of the incoming token(s), from the attention ``pos``
    leaf: every attention layer advances in lockstep, so the first segment's
    layer 0 speaks for all.  A scalar (static batch), a [B] vector (serving
    caches), or None (no attention layer)."""
    for seg in caches:
        if isinstance(seg, dict) and "attn" in seg and "pos" in seg["attn"]:
            return seg["attn"]["pos"][0]
    return None


def _argmax_tokens(logits):
    """Greedy next tokens from the last row of ``logits``: [B, 1] int32, or
    [B, K, 1] from multi-codebook logits [B, S, K, V]."""
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[..., None]


def make_decode_step(cfg: ModelConfig) -> Callable:
    """(params, caches, tokens [B,1] or [B,K,1], tables=None) → (next_tokens
    of the same shape, caches).

    The query position comes from the caches' ``pos`` leaf: without it the
    token would run at position 0, with the wrong RoPE phase and a causal
    mask hiding every cached row but the first.  ``tables`` matter only for
    caches that hold the paged pool."""

    def decode_step(params, caches, tokens, tables=None):
        start = _cache_start(caches)
        if start is not None and start.ndim:
            start = start[:, None]
        logits, caches, _ = lm.forward(params, tokens, cfg, caches=caches,
                                       start_pos=start, tables=tables)
        return _argmax_tokens(logits), caches

    return decode_step


# ---------------------------------------------------------------------------
# continuous-batching serving steps
# ---------------------------------------------------------------------------

def _pool_trash_block(caches) -> Optional[int]:
    """Index of the write-off block of the paged pool (None ⇒ no paged leaves)."""
    for _, name, leaf in leaves_with_path(caches):
        if name in POOL_LEAVES:
            return leaf.shape[1] - 1
    return None


def init_serving_caches(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                        window_headroom: int = 0, round_to: int = 1,
                        block_size: int = 16, n_blocks: int = 0, device=None):
    """Stacked serving caches with *per-slot* position vectors.

    ``lm.init_caches`` except that

    * every ``pos`` leaf is a per-slot ``[L, batch]`` vector, so each slot
      keeps its own length (the attention layer takes the per-slot write
      path and masks per slot); every per-slot leaf then has the slot axis
      at position 1;
    * with ``n_blocks > 0``, pageable segments (``pageable_block``) hold the
      physical block pool ``k_pool/v_pool [L, n_blocks+1, block_size, H_kv,
      D]`` instead of a dense ``[batch, max_len]`` cache; the other segments
      keep theirs;
    * ring buffers get ``window_headroom`` extra rows (rounded up to
      ``round_to``, at most ``max_len``): a prefill chunk of C tokens through
      a ring of exactly ``window`` rows would overwrite keys its own early
      queries still need, and ``window + C`` rows keep every key until the
      last query that may see it has run, which makes chunked prefill exact.
    """
    if dtype is None:
        dtype = lm.kv_dtype(cfg)
    override = None
    if n_blocks:
        override = lambda b: (init_paged_cache(b.attn, n_blocks, block_size, dtype, device)
                              if pageable_block(b) else None)
    caches = lm.init_caches(cfg, batch, max_len, dtype, attn_override=override,
                            device=device)

    def fix(name, leaf):
        if name == "pos":
            return torch.zeros((*leaf.shape, batch), dtype=torch.int32, device=leaf.device)
        if window_headroom and name in ("k", "v") and leaf.shape[2] < max_len:
            size = leaf.shape[2] + window_headroom
            size = min(max_len, -(-size // round_to) * round_to)
            if size > leaf.shape[2]:
                pad = [0, 0] * (leaf.ndim - 3) + [0, size - leaf.shape[2]]
                return torch.nn.functional.pad(leaf, pad)
        return leaf

    return map_with_name(fix, caches)


def _merge(active, caches, new_caches):
    """Per-slot leaves keep their old value on inactive slots; pool leaves
    were written in place (inactive writes went to the write-off block).
    Dense K/V rows and recurrent state come out of the forward as new
    tensors, so the old ones are still there to keep."""
    def merge(name, old, new):
        if name in POOL_LEAVES:
            return new
        m = active.reshape((1, active.shape[0]) + (1,) * (old.ndim - 2))
        return torch.where(m, new, old)

    return map_with_name(merge, caches, new_caches)


def _redirect(tables, active, trash):
    """Inactive slots' tables point at the pool's write-off block (tables
    pass unchanged when the caches hold no pool)."""
    if tables is None or trash is None:
        return tables
    return torch.where(active[:, None], tables, trash)


def make_slot_prefill_step(cfg: ModelConfig, max_len: int, window_headroom: int = 0,
                           round_to: int = 1, block_size: int = 16,
                           paged: bool = True) -> Callable:
    """Chunked prefill of ONE batch slot of a serving cache.

    (params, caches, tokens [1,C] or [1,K,C], slot, start, reset, tables [B,P],
     patch_embeds=None, pos3d=None) → (last_logits [1,V] or [1,K,V], caches)

    Pool leaves pass whole and the chunk's K/V rows go straight into the
    slot's blocks (``paged``; ``tables`` is ignored otherwise).  The slot's
    per-slot leaves are sliced out, run through the forward at positions
    ``[start, start+C)`` and written back.  ``reset`` (a fresh admission, or
    a mid-sequence one behind a shared prefix) first restores them to their
    true initial state, that of ``init_serving_caches`` for one slot: zero
    K/V rows and recurrent state, and ``pos = start``.  ``patch_embeds
    [1, P, d]`` and the chunk's ``pos3d [1, C, 3]`` go to the forward.
    """
    init_kw = dict(window_headroom=window_headroom, round_to=round_to,
                   block_size=block_size, n_blocks=1 if paged else 0)

    def prefill_chunk(params, caches, tokens, slot: int, start: int, reset: bool,
                      tables, patch_embeds=None, pos3d=None):
        def slice_slot(name, leaf, fresh=None):
            if name in POOL_LEAVES:
                return leaf
            if fresh is None:
                return leaf[:, slot:slot + 1]
            return fresh + start if name == "pos" else fresh

        if reset:
            fresh = init_serving_caches(cfg, 1, max_len, device=tokens.device, **init_kw)
            sl = map_with_name(slice_slot, caches, fresh)
        else:
            sl = map_with_name(slice_slot, caches)
        logits, sl, _ = lm.forward(params, tokens, cfg, caches=sl,
                                   patch_embeds=patch_embeds, pos3d=pos3d,
                                   start_pos=start, moe_no_drop=True,
                                   tables=tables[slot:slot + 1] if paged else None)
        for (_, name, leaf), (_, _, new) in zip(leaves_with_path(caches),
                                                leaves_with_path(sl)):
            if name not in POOL_LEAVES:
                leaf[:, slot:slot + 1] = new
        return logits[:, -1], caches

    return prefill_chunk


def _sample_tokens(logits, temperature: float, top_k: int,
                  generator: Optional[torch.Generator]):
    """Next-token pick from ``logits [B, S, V]`` (or [B, S, K, V]): greedy
    argmax, or temperature + top-k sampling (Gumbel-max over float32 logits,
    noise drawn from ``generator``) when ``generator`` is given and
    ``temperature > 0``.  Returns [B, 1] (or [B, K, 1]) int32."""
    last = logits[:, -1]
    greedy = torch.argmax(last, dim=-1).to(torch.int32)
    if generator is None or temperature <= 0:
        return greedy[..., None]
    masked = last.float()
    if top_k:
        kth = torch.topk(masked, top_k, dim=-1).values[..., -1:]
        masked = torch.where(masked >= kth, masked, -1e30)
    u = torch.rand(masked.shape, generator=generator, device=masked.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    scaled = masked / max(temperature, 1e-6) + gumbel
    return torch.argmax(scaled, dim=-1).to(torch.int32)[..., None]


def _decode_forward(params, caches, tokens, lengths, active, tables, cfg: ModelConfig):
    """The activity-masked decode forward over all slots: inactive slots'
    tables point at the write-off block and their per-slot leaves keep their
    values.  Returns (logits, caches)."""
    tables = _redirect(tables, active, _pool_trash_block(caches))
    logits, new_caches, _ = lm.forward(params, tokens, cfg, caches=caches,
                                       start_pos=lengths[:, None], moe_no_drop=True,
                                       tables=tables)
    return logits, _merge(active, caches, new_caches)


def _masked_decode(params, caches, tokens, lengths, active, tables, generator,
                   temperature: float, cfg: ModelConfig, top_k: int):
    """One activity-masked decode over all slots (the shared body of the
    single-step and horizon serving decode).  Returns (next_tokens, caches)."""
    logits, caches = _decode_forward(params, caches, tokens, lengths, active, tables, cfg)
    return _sample_tokens(logits, temperature, top_k, generator), caches


def make_serving_decode_step(cfg: ModelConfig, top_k: int = 0) -> Callable:
    """One decode step over all serving slots with an activity mask.

    (params, caches, tokens [B,1], lengths [B], active [B], tables [B,P],
     generator, temperature) → (next [B,1], caches)

    A multi-codebook model's tokens and next tokens are [B,K,1].
    Inactive slots still flow through the fixed ``[B, 1]`` forward, but their
    writes land in the write-off block and their ``pos`` does not advance.
    """

    def decode_step(params, caches, tokens, lengths, active, tables,
                    generator=None, temperature: float = 0.0):
        return _masked_decode(params, caches, tokens, lengths, active, tables,
                              generator, temperature, cfg, top_k)

    return decode_step


def make_serving_decode_guarded(cfg: ModelConfig, top_k: int = 0) -> Callable:
    """One decode step with a per-slot NaN/Inf logit guard and optional
    fault injection.

    (params, caches, tokens [B,1], lengths [B], active [B], tables [B,P],
     generator, temperature, poison [B]) → (next [B,1], bad [B], caches)
    (tokens and next tokens [B,K,1] for a multi-codebook model)

    The forward is the plain decode step's.  ``poison`` sets the marked
    slots' logits to NaN after it (the PCRAM-drift analog at the logit
    seam), so co-batched slots sample from the same logits as an unguarded
    step.  ``bad[s]`` is True when slot ``s``'s last-row logits hold a
    non-finite value; the engine fails that request and drops its token.
    Finite rows take the plain step's sampling, so they emit the same tokens.
    """

    def decode_step(params, caches, tokens, lengths, active, tables,
                    generator=None, temperature: float = 0.0, poison=None):
        logits, caches = _decode_forward(params, caches, tokens, lengths, active,
                                         tables, cfg)
        if poison is not None:
            m = poison.reshape((-1,) + (1,) * (logits.ndim - 1))
            logits = torch.where(m, torch.nan, logits)
        last = logits[:, -1]
        bad = ~torch.isfinite(last.reshape(last.shape[0], -1)).all(dim=-1)
        return _sample_tokens(logits, temperature, top_k, generator), bad, caches

    return decode_step


def make_serving_mixed_step(cfg: ModelConfig, top_k: int = 0) -> Callable:
    """ONE dispatch carrying decode rows AND prefill-chunk rows together.

    (params, caches, tokens [B,Q], lengths [B], q_lens [B], decode [B],
     active [B], tables [B,P], generator, temperature)
        → (next_tokens [B,1], last_logits [B,V], caches)
    (tokens [B,K,Q], next tokens [B,K,1] and last logits [B,K,V] for a
    multi-codebook model)

    Every slot contributes ``q_lens[s]`` real query rows, right-aligned in
    the ``Q`` columns: a decode slot rides at ``q_lens = 1`` (flagged in
    ``decode``), a prefilling slot carries a chunk of its prompt.  Decode
    rows take the paged kernel and prefill rows the gather+sdpa core, so each
    emitted token equals what the separate dispatches produce.  Inactive
    slots run with ``q_lens = 0``; their rows are pad rows.  ``lengths`` is
    the per-slot cached length before this dispatch.
    """

    def mixed_step(params, caches, tokens, lengths, q_lens, decode, active,
                   tables, generator=None, temperature: float = 0.0):
        Q = tokens.shape[-1]
        q_lens = torch.where(active, q_lens, 0)
        tabs = _redirect(tables, active, _pool_trash_block(caches))
        # row 0 of the tile sits q_lens-Q rows before the slot's next
        # position (pad rows get earlier, possibly negative, positions)
        start = (lengths + q_lens - Q)[:, None]
        logits, new_caches, _ = lm.forward(params, tokens, cfg, caches=caches,
                                           start_pos=start, moe_no_drop=True, tables=tabs,
                                           q_lens=q_lens, q_decode=decode & active)
        caches = _merge(active, caches, new_caches)
        nxt = _sample_tokens(logits, temperature, top_k, generator)
        return nxt, logits[:, -1], caches

    return mixed_step


def make_serving_decode_horizon(cfg: ModelConfig, H: int, top_k: int = 0) -> Callable:
    """``H`` decode steps in ONE dispatch, the carry kept on the device.

    (params, caches, tokens [B,1] or [B,K,1], lengths [B], active [B],
     remaining [B], tables [B,P], generators, temperature, eos_id)
        → (token_block [B, H] or [B, K, H], counts [B], last_tokens, caches)

    Each inner step runs the activity-masked decode and feeds its token back
    as the next input.  A slot freezes once its ``remaining`` budget reaches
    zero or it emits ``eos_id`` (``< 0`` disables EOS; a multi-codebook
    frame ends on its first codebook); frozen slots keep flowing through the
    forward with their cache updates discarded.  Slot ``s``'s valid tokens
    are ``token_block[s, ..., :counts[s]]``.  ``generators`` holds one
    generator per inner step (None for greedy).
    """

    def horizon_step(params, caches, tokens, lengths, active, remaining, tables,
                     generators=None, temperature: float = 0.0, eos_id: int = -1):
        B = lengths.shape[0]
        tok_mask_shape = (B,) + (1,) * (tokens.ndim - 1)
        toks, emitted = [], []
        tok, act, rem = tokens, active, remaining
        for h in range(H):
            gen = generators[h] if generators is not None else None
            nxt, caches = _masked_decode(params, caches, tok, lengths, act, tables,
                                         gen, temperature, cfg, top_k)
            first = nxt.reshape(B, -1)[:, 0]
            hit_eos = (first == eos_id) if eos_id >= 0 else torch.zeros_like(act)
            step = act.to(torch.int32)
            rem = rem - step
            lengths = lengths + step
            toks.append(nxt)
            emitted.append(act)
            tok = torch.where(act.reshape(tok_mask_shape), nxt, tok)
            act = act & (rem > 0) & ~hit_eos
        counts = torch.stack(emitted).to(torch.int32).sum(dim=0)          # [B]
        block = torch.cat(toks, dim=-1)                          # [B, H] / [B, K, H]
        return block, counts, tok, caches

    return horizon_step


# ---------------------------------------------------------------------------
# n-gram self-speculative decode (draft-free prompt-lookup verification)
# ---------------------------------------------------------------------------

def speculable(cfg: ModelConfig) -> bool:
    """Whether the config supports n-gram self-speculative serving decode.

    Rollback of rejected draft rows is a length decrement, sound exactly when
    every piece of decode state is position-addressed (paged pool blocks,
    dense K/V rows, MLA's latent rows: stale rows past the length are
    invisible to every later query).
    Recurrent state advances per token and cannot be truncated, and
    multi-codebook frames have no scalar n-gram to match."""
    return cfg.n_codebooks == 1 and all(
        b.kind in ("dense", "moe") and b.attn is not None for b in cfg.blocks)


def ngram_propose(hist, K: int, n: int = 2):
    """Draft ``K`` tokens per slot by prompt-lookup over the token history.

    ``hist [B, W]`` holds each slot's most recent context tokens
    right-aligned (prompt tail + generated ids, ``-1`` padding on the left).
    The final ``n``-gram is matched against every earlier offset in one
    vectorised comparison on the device; the draft is the ``K`` tokens that
    followed the most recent match.  No match degenerates to repeating the
    last token, which the verify step simply rejects."""
    B, W = hist.shape
    J = W - n - K + 1               # candidate starts; excludes the tail itself
    if J < 1:
        raise ValueError(f"history window {W} too short for n={n}, K={K}")
    tail = hist[:, W - n:]
    m = torch.ones((B, J), dtype=torch.bool, device=hist.device)
    for i in range(n):
        m = m & (hist[:, i:i + J] == tail[:, i:i + 1])
    starts = torch.arange(J, dtype=torch.int32, device=hist.device)
    best = torch.where(m, starts, -1).amax(dim=1)
    has = best >= 0
    cols = (best.clamp_min(0)[:, None] + n
            + torch.arange(K, dtype=torch.int32, device=hist.device))
    draft = torch.gather(hist, 1, cols.long())                    # [B, K]
    draft = torch.where(has[:, None], draft, hist[:, -1:])
    return draft.clamp_min(0)       # padding can leak into a boundary draft


def _spec_merge(old_caches, new_caches, active, m):
    """Merge a K+1-token verify forward's cache updates with per-slot
    rollback: ``pos`` leaves advance by the per-slot accepted count ``m``
    (rows past ``pos + m`` hold rejected-draft K/V and stay invisible),
    pool leaves keep their in-place writes (inactive slots wrote to the
    write-off block), other per-slot leaves select by the activity mask."""
    def merge(name, old, new):
        if name in POOL_LEAVES:
            return new
        if name == "pos":
            return old + m[None, :]                     # [L, B] + [1, B]
        mask = active.reshape((1, active.shape[0]) + (1,) * (old.ndim - 2))
        return torch.where(mask, new, old)

    return map_with_name(merge, old_caches, new_caches)


def make_serving_spec_horizon(cfg: ModelConfig, H: int, K: int,
                              n: int = 2) -> Callable:
    """``H`` draft→verify→accept steps in ONE dispatch, the carry kept on
    the device.

    (params, caches, tokens [B,1], lengths [B], active [B], remaining [B],
     hist [B,W], tables [B,P], eos_id)
        → (token_block [B, H, K+1], counts [B, H], last_tokens [B, 1],
           hist, caches)

    Each inner step drafts ``K`` tokens with :func:`ngram_propose`, runs ONE
    forward over ``[pending, d_1..d_K]`` (the paged kernel's ``K+1``-token
    verify tile), accepts the longest draft prefix equal to the greedy
    argmaxes plus the bonus argmax (``1..K+1`` tokens, every one an argmax,
    so the stream equals plain greedy decode), advances lengths by that
    count only (clamped by ``remaining`` and a mid-tile EOS: rollback is a
    length decrement, never a copy) and shifts the emitted run into the
    history ring.  ``counts[s, h]`` is the number of valid tokens in
    ``token_block[s, h]`` (0 once the slot froze).  Greedy only.
    """
    if K < 1:
        raise ValueError(f"spec draft length K must be >= 1, got {K}")

    def spec_step(params, caches, tokens, lengths, active, remaining, hist,
                  tables, eos_id: int = -1):
        W = hist.shape[1]
        trash = _pool_trash_block(caches)
        rows = torch.arange(W, dtype=torch.int32, device=hist.device)[None, :]
        toks, counts = [], []
        tok, act, rem = tokens, active, remaining
        for _ in range(H):
            draft = ngram_propose(hist, K, n)                       # [B, K]
            tabs = _redirect(tables, act, trash)
            tin = torch.cat([tok, draft], dim=1)                    # [B, K+1]
            logits, new_caches, _ = lm.forward(
                params, tin, cfg, caches=caches, start_pos=lengths[:, None],
                moe_no_drop=True, tables=tabs, spec_decode=True)
            g = torch.argmax(logits, dim=-1).to(torch.int32)        # [B, K+1]
            # d_j is accepted while it equals the argmax one position earlier
            match = (draft == g[:, :K]).to(torch.int32)
            acc = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
            is_eos = (g == eos_id) & (eos_id >= 0)
            has_eos = is_eos.any(dim=1)
            # argmax takes no bool; it returns the first maximum
            first = torch.argmax(is_eos.to(torch.int32), dim=1).to(torch.int32)
            eos_cut = torch.where(has_eos, first + 1, K + 1)
            m = torch.minimum(torch.minimum(acc + 1, rem), eos_cut)
            m = torch.where(act, m, 0)                              # emitted count
            caches = _spec_merge(caches, new_caches, act, m)
            lengths = lengths + m
            rem = rem - m
            last = torch.gather(g, 1, (m - 1).clamp_min(0)[:, None].long())
            tok = torch.where((m > 0)[:, None], last, tok)
            hit_eos = has_eos & (eos_cut <= m)                      # eos was emitted
            act = act & (rem > 0) & ~hit_eos
            ext = torch.cat([hist, g], dim=1)                       # [B, W+K+1]
            hist = torch.gather(ext, 1, (m[:, None] + rows).long())
            toks.append(g)
            counts.append(m)
        return (torch.stack(toks, dim=1), torch.stack(counts, dim=1), tok, hist,
                caches)

    return spec_step
