"""Attention: GQA over the paged physical KV pool and the dense caches, and
DeepSeek's multi-head latent attention (MLA) over its compressed cache.

The port of the JAX package's ``nn/attention.py``:

* the physical block pool ``k_pool/v_pool [n_blocks+1, block_size, H_kv, D]``
  is shared by every serving slot; per-slot block ``tables`` map logical
  pages to pool blocks, and the last block is the write-off target for
  inactive slots and pad rows (``init_paged_cache``);
* decode rows attend in place through :func:`paged_attention` (the CUDA
  kernel on the card); the rows of a chunked prefill or a mixed tile attend
  in place through :func:`chunk_attn` (a flash-attention CUDA kernel) when q
  is bf16 on the card and the pool bf16 or int8 (D 64 or 128, a block size
  dividing 64); otherwise (the CPU, a float32 q or pool) chunked prefill
  gathers the table's pages once and runs the plain ``sdpa`` core, as the
  JAX package does with jnp;
* the dense cache ``k/v [B, S_max, H_kv, D]`` or, with ``window > 0``, a
  ring buffer of ``window`` rows (``init_cache``), with a scalar ``pos``
  (static batch) or a per-slot ``pos [B]`` (serving); these run the plain
  ``sdpa`` core, as the JAX package runs jnp there;
* MLA caches the normed latent ``c_kv [B, S_max, kv_lora_rank]`` and the
  shared RoPE key ``k_rope [B, S_max, qk_rope_dim]`` (``init_cache``), a
  scalar or per-slot ``pos`` as the dense cache, and decompresses the whole
  cache through ``k_up``/``v_up`` for every forward before the plain
  ``sdpa`` core (the reference's algorithm).

K/V rows are written into the pool **in place** (the JAX package returns a
new pool array; here the cache tensors are updated where they lie, which
saves a pool-sized copy per layer).  The returned cache dict holds the same
pool tensors and a new ``pos`` vector.  Dense and ring rows are written
**out of place**, as the JAX package writes them, and so are MLA's latent
rows: the serving steps merge each slot's old and new cache by its activity
mask, which needs both.  GQA rotates q and k with RoPE or, for Qwen2-VL,
M-RoPE over (t, h, w) position ids (``pos3d``; without them every axis
takes the token's position).

On DTensors (a sharded run, the dry-run) a dense or MLA cache placed by
``launch/specs.py cache_pspecs`` (batch on ``data``, rows on ``model``) is
written rank by rank, each rank its own rows (``_put_rows_sharded``), and a
decode step attends as a flash decode: each rank over its own rows, the
softmax partials combined by all-reduces (``_flash_decode``); longer query
tiles run each rank's (batch, head) block (``_sharded_sdpa``).

Under the profiler each cache-taking core (``_paged_gqa_core``,
``_dense_gqa_core``, ``_mla_cache_core``: the cache writes and the attention
over the cache, not the projections) runs inside an ``attn/core`` range
(``repro_torch.obs``).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch import obs
from repro_torch.configs.base import AttnConfig
from repro_torch.kernels.chunk_attn import chunk_attn, covers as chunk_attn_covers
from repro_torch.kernels.paged_attn import paged_attention
from repro_torch.nn.layers import apply_mrope, apply_rope, linear, linear_spec, rmsnorm
from repro_torch.nn.module import ParamSpec
from repro_torch.nn.pcontext import (collective_scope, contiguous_grad, from_block,
                                     is_dtensor, reshape, to_block)

__all__ = ["attn_spec", "attention", "init_cache", "init_paged_cache", "sdpa",
           "DEFAULT_CHUNK", "KV_SCALE", "POOL_LEAVES"]

# Cache-leaf names of the paged physical KV store (no slot axis).
POOL_LEAVES = ("k_pool", "v_pool")

DEFAULT_CHUNK = 512
NEG_INF = -1e30
# int8 KV-cache fixed-point scale: values quantize as round(x·16) ∈ [-127,127]
# (range ±7.94, step 1/16) — ODIN's 8-bit-operand adjustment applied to the
# decode working set.
KV_SCALE = 16.0



def _cache_write(x: torch.Tensor, cache_dtype) -> torch.Tensor:
    if cache_dtype == torch.int8:
        return torch.clamp(torch.round(x.float() * KV_SCALE), -127, 127).to(torch.int8)
    return x.to(cache_dtype)


def _cache_read(x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    if x.dtype == torch.int8:
        return (x.float() * (1.0 / KV_SCALE)).to(compute_dtype)
    return x


# ---------------------------------------------------------------------------
# parameter specs and caches
# ---------------------------------------------------------------------------

def attn_spec(cfg: AttnConfig, d_model: int) -> Dict[str, ParamSpec]:
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    if cfg.kind == "mla":
        qk_dim = cfg.qk_nope_dim + cfg.qk_rope_dim
        spec = {
            "kv_down": linear_spec(d_model, cfg.kv_lora_rank + cfg.qk_rope_dim, ("embed", None)),
            "kv_norm": ParamSpec((cfg.kv_lora_rank,), (None,), torch.float32, init="ones"),
            "k_up": linear_spec(cfg.kv_lora_rank, H * cfg.qk_nope_dim, (None, "heads_flat")),
            "v_up": linear_spec(cfg.kv_lora_rank, H * cfg.v_head_dim, (None, "heads_flat")),
            "o": linear_spec(H * cfg.v_head_dim, d_model, ("heads_flat", "embed")),
        }
        if cfg.q_lora_rank:
            spec["q_down"] = linear_spec(d_model, cfg.q_lora_rank, ("embed", None))
            spec["q_norm"] = ParamSpec((cfg.q_lora_rank,), (None,), torch.float32,
                                       init="ones")
            spec["q_up"] = linear_spec(cfg.q_lora_rank, H * qk_dim, (None, "heads_flat"))
        else:
            spec["q"] = linear_spec(d_model, H * qk_dim, ("embed", "heads_flat"))
        return spec
    return {
        "q": linear_spec(d_model, H * D, ("embed", "heads_flat")),
        "k": linear_spec(d_model, Hkv * D, ("embed", "heads_flat")),
        "v": linear_spec(d_model, Hkv * D, ("embed", "heads_flat")),
        "o": linear_spec(H * D, d_model, ("heads_flat", "embed")),
    }


def init_cache(cfg: AttnConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    """Dense decode cache of one layer with a scalar ``pos``: for GQA
    ``k/v [batch, size, H_kv, D]`` with ``size = window`` (a ring buffer) or
    ``max_len``; for MLA the compressed ``c_kv [batch, max_len,
    kv_lora_rank]`` and ``k_rope [batch, max_len, qk_rope_dim]``."""
    pos = torch.zeros((), dtype=torch.int32, device=device)
    if cfg.kind == "mla":
        return {
            "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                                  device=device),
            "pos": pos,
        }
    size = cfg.window if cfg.window else max_len
    shape = (batch, size, cfg.n_kv_heads, cfg.d_head)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": pos,
    }


def init_paged_cache(cfg: AttnConfig, n_blocks: int, block_size: int,
                     dtype=torch.bfloat16, device=None):
    """Paged physical KV store for one GQA layer.

    One block pool ``[n_blocks+1, block_size, H_kv, D]`` per K and V, shared
    by every serving slot.  Block ``n_blocks`` is the *write-off block*:
    inactive slots' tables point at it so their writes land somewhere
    harmless.
    """
    if cfg.kind != "gqa" or cfg.window:
        raise ValueError("paged cache supports non-windowed GQA only")
    shape = (n_blocks + 1, block_size, cfg.n_kv_heads, cfg.d_head)
    return {
        "k_pool": torch.zeros(shape, dtype=dtype, device=device),
        "v_pool": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# softmax attention cores
# ---------------------------------------------------------------------------

def _mask_bias(q_pos, k_pos, window: int):
    """[.., Sq, Sk] additive bias: causal + optional sliding window."""
    ok = k_pos[..., None, :] <= q_pos[..., :, None]
    if window:
        ok &= k_pos[..., None, :] > q_pos[..., :, None] - window
    return torch.where(ok, 0.0, NEG_INF)


def _sdpa(q, k, v, bias, scale):
    """q: [B,Sq,H,D] k/v: [B,Sk,Hkv,Dk/Dv] bias: [B,1,Sq,Sk] or [1,1,Sq,Sk]."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    s = s + bias[:, :, None, :, :]
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def _blockwise(q, k, v, q_pos, k_pos, window: int, scale: float, chunk: int):
    """Flash-style double loop: outer over Q chunks, inner over KV chunks
    with an online softmax (the JAX package's ``lax.map``/``lax.scan``)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    Dv = v.shape[-1]
    Hkv = k.shape[2]
    G = H // Hkv
    cq = min(chunk, Sq)
    ck = min(chunk, Sk)
    if Sq % cq or Sk % ck:
        raise ValueError((Sq, Sk, chunk))
    q_pos = q_pos.expand(B, Sq) if q_pos.ndim < 2 else q_pos
    k_pos = k_pos.expand(B, Sk) if k_pos.ndim < 2 else k_pos
    outs = []
    for q0 in range(0, Sq, cq):
        qi = q[:, q0:q0 + cq].reshape(B, cq, Hkv, G, D).float()
        qp = q_pos[:, q0:q0 + cq]
        m = torch.full((B, Hkv, G, cq), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, Hkv, G, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, Hkv, G, cq, Dv), dtype=torch.float32, device=q.device)
        for k0 in range(0, Sk, ck):
            ki, vi = k[:, k0:k0 + ck].float(), v[:, k0:k0 + ck].float()
            s = torch.einsum("bqhgd,bkhd->bhgqk", qi, ki) * scale
            s = s + _mask_bias(qp, k_pos[:, k0:k0 + ck], window)[:, None, None]
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vi)
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(torch.movedim(o, 3, 1).to(q.dtype))     # [B, cq, Hkv, G, Dv]
    return torch.cat(outs, dim=1).reshape(B, Sq, H, Dv)


def _rows(pos, mesh, batch_pl, offset: int, n: int):
    """This rank's rows ``offset .. offset+n`` of a position tensor: a
    DTensor's local rows of its batch sharding, a plain 2-D one sliced, a
    1-D (shared) one as it is."""
    if is_dtensor(pos):
        return pos.redistribute(mesh, batch_pl[:pos.device_mesh.ndim]).to_local() \
            if pos.dim() == 2 else pos.full_tensor()
    return pos[offset:offset + n] if pos.dim() == 2 and pos.shape[0] > 1 else pos


def _sharded_sdpa(q, k, v, q_pos, k_pos, window, chunk, blockwise_threshold):
    """``sdpa`` of DTensor q/k/v, each rank on its own (batch, head) block:
    batch sharded as ``q``'s is, heads over the other mesh dims that divide
    the KV heads (a query head's KV head then lives on the same rank), the
    sequence whole.  The local result is this rank's block of the output.
    A long block attends in chunks as large as the direct path's bound
    (``blockwise_threshold`` rows), not the caller's ``chunk``: a 32k-token
    prefill takes 64 eager chunk pairs a layer, where chunks of 512 would
    take 4,096 (each a dozen ops: kernel launches on the card, and Python
    dispatch when the dry-run traces the step on meta tensors).  The price
    is float32 scores of ``blockwise_threshold``² a local head, 64× those
    of the 512-row blocks one device keeps, and the dry-run's prefill
    memory records carry it.  The online softmax then runs in another
    block order than one device's, so the two agree within float32's
    reordered sums, not bit for bit."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = q.device_mesh
    B, Sq, H, _ = q.shape
    Hkv = k.shape[2]
    batch_dims = [i for i, p in enumerate(q.placements) if isinstance(p, Shard) and p.dim == 0]
    pl, m = [], 1
    for i, p in enumerate(q.placements):
        if i in batch_dims:
            pl.append(Shard(0))
        elif Hkv % (m * mesh.size(i)) == 0:
            pl.append(Shard(2))
            m *= mesh.size(i)
        else:
            pl.append(Replicate())
    pl = tuple(pl)
    # the local blocks' gradients come back contiguous, as DTensor's own
    # views of them assume
    ql, kl, vl = (contiguous_grad(t.redistribute(mesh, pl).to_local()) for t in (q, k, v))
    _, off = compute_local_shape_and_global_offset(q.shape, mesh, pl)
    batch_pl = tuple(Shard(0) if i in batch_dims else Replicate() for i in range(mesh.ndim))
    qp = _rows(q_pos, mesh, batch_pl, off[0], ql.shape[0])
    kp = _rows(k_pos, mesh, batch_pl, off[0], ql.shape[0])
    out = contiguous_grad(sdpa(ql, kl, vl, qp, kp, window, max(chunk, blockwise_threshold),
                               blockwise_threshold))
    return from_block(out, mesh, pl, (B, Sq, H, v.shape[-1]))


def _seq_dims(k):
    """The mesh dims that shard DTensor ``k``'s sequence axis (axis 1)."""
    from torch.distributed.tensor import Shard

    return [i for i, p in enumerate(k.placements) if isinstance(p, Shard) and p.dim == 1]


def _whole(x):
    """A replicated DTensor's value (every rank holds it), a plain tensor as
    it is."""
    return x.full_tensor() if is_dtensor(x) else x


def _decode_partials(q, k, v, q_pos, k_pos, window: int, scale: float):
    """One rank's flash-decode partials over its own key rows: q ``[B, H,
    D]`` (one query row), k/v ``[B, Sk, Hkv, D/Dv]``, positions ``[B]`` and
    ``[B, Sk]``.  Returns the row max ``m [B, H]``, the denominator ``l [B,
    H]`` and the numerator ``o [B, H, Dv]``, float32, relative to ``m``."""
    B, H, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k.float()) * scale
    s = s + _mask_bias(q_pos[:, None], k_pos, window)[:, None, None, 0, :]
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    return m.reshape(B, H), p.sum(-1).reshape(B, H), o.reshape(B, H, v.shape[-1])


def _flash_combine(m, l, o, mesh, out_pl, seq_dims, B: int):
    """Combine the ranks' flash-decode partials over the mesh dims
    ``seq_dims`` that shard the keys: a MAX all-reduce of the row max, then
    SUM all-reduces of the rescaled denominator and numerator.  A rank
    whose keys are all invisible has a row max near -1e30 and is rescaled
    by exactly 0.  Returns this rank's ``[B_local, H, Dv]`` output."""
    from torch.distributed.tensor import Partial

    def reduce(t, op):
        part = tuple(Partial(op) if i in seq_dims else p for i, p in enumerate(out_pl))
        return from_block(t, mesh, part, (B, *t.shape[1:])).redistribute(
            mesh, out_pl).to_local()

    with collective_scope("attention partials"):
        m_all = reduce(m, "max")
        w = torch.exp(m - m_all)
        l_all = reduce(l * w, "sum")
        o_all = reduce(o * w[..., None], "sum")
    return o_all / l_all[..., None]


def _flash_decode(q, k, v, q_pos, k_pos, window: int, kv_local=None):
    """One query row against keys sequence-sharded over the mesh (the
    decode cache's ``kv_seq → model``): each rank attends over its own key
    rows and the partials are combined (:func:`_flash_combine`); no rank
    gathers the cache.  q ``[B, 1, H, D]``; k/v DTensors ``[B, Sk, Hkv,
    D/Dv]`` — or, with ``kv_local(k_block) → (k, v)``, the rows from which
    each rank makes its own keys and values (MLA's latents).  The output is
    ``[B, 1, H, Dv]``, batch sharded as the keys' is."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = k.device_mesh
    B, _, H, D = q.shape
    seq_dims = _seq_dims(k)
    kv_pl = tuple(p if isinstance(p, Shard) and p.dim in (0, 1) else Replicate()
                  for p in k.placements)
    out_pl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                   for p in k.placements)
    if kv_local is None:
        kl, vl = to_block(k, mesh, kv_pl), to_block(v, mesh, kv_pl)
    else:
        kl, vl = kv_local(to_block(k, mesh, kv_pl))
    ql = to_block(q, mesh, out_pl, kv_pl)[:, 0]
    kp = to_block(_whole(k_pos).expand(B, k.shape[1]), mesh, kv_pl)
    qp = to_block(_whole(q_pos).expand(B, 1), mesh, out_pl)[:, 0]
    m, l, o = _decode_partials(ql, kl, vl, qp, kp, window, 1.0 / math.sqrt(D))
    out = _flash_combine(m, l, o, mesh, out_pl, seq_dims, B).to(q.dtype)
    return from_block(out[:, None], mesh, out_pl, (B, 1, H, out.shape[-1]))


def sdpa(q, k, v, q_pos, k_pos, window: int = 0, chunk: int = DEFAULT_CHUNK,
         blockwise_threshold: int = 4096):
    """Dispatch between direct and blockwise attention. Shapes as in _sdpa.
    DTensor q/k/v run per rank on local blocks: one query row against
    sequence-sharded keys as a flash decode (``_flash_decode``), anything
    else on (batch, head) blocks (``_sharded_sdpa``)."""
    if is_dtensor(q):
        if q.shape[1] == 1 and _seq_dims(k):
            return _flash_decode(q, k, v, q_pos, k_pos, window)
        return _sharded_sdpa(q, k, v, q_pos, k_pos, window, chunk, blockwise_threshold)
    scale = 1.0 / math.sqrt(q.shape[-1])
    B = q.shape[0]
    Sq, Sk = q.shape[1], k.shape[1]
    if Sq == 1 or (Sq * Sk) <= blockwise_threshold ** 2:
        qp = q_pos if q_pos.ndim == 2 else q_pos.expand(B, Sq)
        kp = k_pos.expand(B, Sk) if k_pos.ndim == 1 else k_pos
        bias = _mask_bias(qp, kp, window)[:, None]          # [B,1,Sq,Sk]
        return _sdpa(q, k, v, bias, scale)
    # blockwise: pad both sequence axes to the chunk size.  Padded K rows get
    # position 2^30 (causally invisible to every real query); padded Q rows
    # get 2^29 (see everything real, row results are sliced away).
    pq = (-Sq) % min(chunk, max(Sq, 1))
    pk = (-Sk) % min(chunk, max(Sk, 1))
    if pq or pk:
        qp = q_pos if q_pos.ndim == 2 else q_pos.expand(B, Sq)
        kp = k_pos if k_pos.ndim == 2 else k_pos.expand(B, Sk)
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pq))
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pk))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pk))
        qp = torch.nn.functional.pad(qp, (0, pq), value=2**29)
        kp = torch.nn.functional.pad(kp, (0, pk), value=2**30)
        return _blockwise(q, k, v, qp, kp, window, scale, chunk)[:, :Sq]
    return _blockwise(q, k, v, q_pos, k_pos, window, scale, chunk)


# ---------------------------------------------------------------------------
# paged GQA
# ---------------------------------------------------------------------------

def _gather_attend(q, kp, vp, tables, positions, visible, window: int):
    """Chunked-prefill numerics: gather the table's pages once, mask keys at
    or past each slot's ``visible`` length, run the sdpa core."""
    B = q.shape[0]
    P = tables.shape[1]
    _, bs, Hkv, D = kp.shape
    tab = tables.long()
    ck = _cache_read(kp[tab].reshape(B, P * bs, Hkv, D), q.dtype)
    cv = _cache_read(vp[tab].reshape(B, P * bs, Hkv, D), q.dtype)
    slot_rows = torch.arange(P * bs, dtype=torch.int32, device=q.device)[None, :]
    k_pos = torch.where(slot_rows < visible[:, None], slot_rows, 2**30).to(torch.int32)
    return sdpa(q, ck, cv, positions, k_pos, window)


def _chunk_core(q, kp, vp, tables, positions, visible, q_lens, window: int, kv_scale):
    """The rows of a chunked prefill or a mixed tile: :func:`chunk_attn`
    in place over the pool where it covers q and the pool (a bf16 q over a
    bf16 or int8 pool on the card, a head dim and block size it takes),
    else :func:`_gather_attend`.  ``q_lens`` (None: all S rows real) are the
    rows the kernel attends; the gather core attends every row."""
    if chunk_attn_covers(q, kp):
        return chunk_attn(q, kp, vp, tables, visible, q_lens, window=window,
                          kv_scale=kv_scale)
    return _gather_attend(q, kp, vp, tables, positions, visible, window)


@obs.ranged("attn/core")
def _paged_gqa_core(q, k, v, cfg: AttnConfig, positions, cache, tables,
                    spec_decode: bool = False, q_lens=None, q_decode=None):
    """Write the new K/V rows into the block pool and attend through it.

    ``pos`` is a per-slot [B] vector; ``tables [B, P]`` maps each slot's
    logical pages to pool blocks.  Decode (S == 1) and a speculative verify
    tile (``spec_decode``) run :func:`paged_attention`; chunked prefill
    (S > 1) runs :func:`_chunk_core`: :func:`chunk_attn` in place over the
    pool (bf16 flash attention with float32 softmax and a split P, see its
    kernel) where it covers q and the pool, else :func:`_gather_attend`, the
    table's pages gathered once and the float32 ``sdpa``.

    ``q_lens`` (mixed prefill+decode dispatch): int32 [B] real query rows per
    slot, right-aligned in the S-row tile.  Pad rows write to the write-off
    block; ``pos`` advances by ``q_lens``.  The mixed tile runs BOTH cores
    and selects per slot: prefill slots take the chunk core (which gives pad
    rows 0, or under ``_gather_attend`` whatever their earlier positions
    see; no real row reads them), slots flagged in ``q_decode`` [B] take the
    paged kernel on the tile's last column — exactly the dedicated decode
    dispatch's call, so mixed-on streams equal mixed-off streams token for
    token.  The chunk kernel skips the flagged slots' rows (their ``q_lens``
    go in as 0), since the decode output replaces them; a real row's result
    does not depend on the tile it rides in.

    Writes for rows at or past the table's page span are redirected to the
    write-off block (a stale table entry there could alias another slot's
    live block).
    """
    if tables is None:
        raise ValueError("paged attention cache requires block tables")
    B, S = q.shape[0], q.shape[1]
    P = tables.shape[1]
    pos = cache["pos"]
    kp, vp = cache["k_pool"], cache["v_pool"]
    cdt = kp.dtype
    bs = kp.shape[1]
    trash = kp.shape[0] - 1
    kv_scale = KV_SCALE if cdt == torch.int8 else None
    idx = torch.arange(S, dtype=torch.int32, device=q.device)[None, :]
    if q_lens is not None:
        off = (S - q_lens)[:, None]                                # pad rows
        rows = pos[:, None] + idx - off                            # [B, S]
        real = idx >= off
        page = torch.where(real, torch.div(rows, bs, rounding_mode="floor"), P)
        slot = torch.where(real, rows % bs, 0)
        new_pos = pos + q_lens
    else:
        rows = pos[:, None] + idx                                  # [B, S]
        page = torch.div(rows, bs, rounding_mode="floor")
        slot = rows % bs
        new_pos = pos + S
    bids = torch.gather(tables, 1, torch.clamp(page, max=P - 1).long())
    bids = torch.where(page >= P, trash, bids).long()
    kp[bids, slot.long()] = _cache_write(k, cdt)
    vp[bids, slot.long()] = _cache_write(v, cdt)
    new_cache = {"k_pool": kp, "v_pool": vp, "pos": new_pos}
    if q_lens is not None:
        rows = q_lens if q_decode is None else torch.where(q_decode, 0, q_lens)
        o = _chunk_core(q, kp, vp, tables, positions, new_pos, rows, cfg.window, kv_scale)
        if q_decode is not None:
            od = paged_attention(q[:, -1], kp, vp, tables, new_pos,
                                 window=cfg.window, kv_scale=kv_scale)
            last = torch.where(q_decode[:, None, None], od, o[:, -1])
            o = torch.cat([o[:, :-1], last[:, None]], dim=1)
    elif S == 1:
        o = paged_attention(q[:, 0], kp, vp, tables, new_pos,
                            window=cfg.window, kv_scale=kv_scale)[:, None]
    elif spec_decode:
        o = paged_attention(q, kp, vp, tables, new_pos,
                            window=cfg.window, kv_scale=kv_scale)
    else:
        o = _chunk_core(q, kp, vp, tables, positions, new_pos, None, cfg.window, kv_scale)
    return o, new_cache


# ---------------------------------------------------------------------------
# dense and ring-buffer GQA caches
# ---------------------------------------------------------------------------

def _ring_positions(next_pos, size: int):
    """Absolute position of each ring-buffer slot given ``next_pos`` total
    written (2^30, invisible, for a slot not written yet)."""
    slots = torch.arange(size, dtype=torch.int32, device=next_pos.device)
    wrapped = next_pos - 1 - (next_pos - 1 - slots) % size
    return torch.where(slots < next_pos, wrapped, 2**30).to(torch.int32)


def _put_rows_sharded(cache, dst, new):
    """``_put_rows`` on a DTensor cache placed by ``launch/specs.py
    cache_pspecs`` (batch and rows sharded): each rank writes the rows of
    its own shard — the batch rows of its batch shard and, of those, the
    cache rows in ``[offset, offset + local)`` of its row shard; any other
    ``dst`` (below the offset too) is dropped on that rank."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh, pl = cache.device_mesh, tuple(cache.placements)
    local, off = compute_local_shape_and_global_offset(cache.shape, mesh, pl)
    rows = to_block(new, mesh, tuple(Replicate() if isinstance(p, Shard) and p.dim == 1
                                     else p for p in pl))
    d = _whole(dst)
    if d.shape[0] > 1:
        d = d[off[0]:off[0] + local[0]]
    d = d.long() - off[1]
    d = torch.where((d >= 0) & (d < local[1]), d, local[1])
    return from_block(_put_rows(cache.to_local(), d, rows), mesh, pl, cache.shape)


def _put_rows(cache, dst, new):
    """``cache [B, size, ...]`` with row ``dst[b, j]`` of slot ``b`` set to
    ``new[b, j]``, out of place.  A ``dst`` at or past ``size`` is dropped,
    as JAX drops an out-of-bounds scatter: each such row lands in a pad row
    of its own, cut off again.  A DTensor cache is written rank by rank
    (``_put_rows_sharded``)."""
    if is_dtensor(cache):
        return _put_rows_sharded(cache, dst, new)
    B, size = cache.shape[0], cache.shape[1]
    S = dst.shape[-1]
    out = torch.cat([cache, cache.new_zeros((B, S, *cache.shape[2:]))], dim=1)
    pad = size + torch.arange(S, device=dst.device)
    dst = torch.where(dst < size, dst.long(), pad).expand(B, S)
    out[torch.arange(B, device=dst.device)[:, None], dst] = new
    return out[:, :size]


def _chunk_rows(pos, idx, S: int, size: int, ring: bool = False):
    """(rows, nxt): the cache rows that the chunk's rows ``idx`` (of ``S``)
    at ``pos`` go to, and the length after the chunk.  A per-slot ``pos
    [B]`` gives rows ``[B, len(idx)]`` (those past the cache are dropped by
    :func:`_put_rows`) and ``nxt [B, 1]``; a scalar ``pos`` gives rows
    ``[1, len(idx)]`` from a start clamped as ``dynamic_update_slice``
    clamps it (not for a ring, whose rows wrap) and a scalar ``nxt``."""
    if pos.ndim:
        return pos[:, None] + idx, (pos + S)[:, None]
    if not ring and S > size:
        raise ValueError(f"a chunk of {S} rows does not fit a cache of {size}")
    start = pos if ring else torch.clamp(pos, 0, size - S)
    return (start + idx)[None, :], pos + S


def _visible_rows(nxt, size: int, device):
    """Positions of a dense cache's rows: row ``j`` where ``j < nxt``, else
    2^30 (invisible to every query)."""
    slot_rows = torch.arange(size, dtype=torch.int32, device=device)
    return torch.where(slot_rows < nxt, slot_rows, 2**30).to(torch.int32)


@obs.ranged("attn/core")
def _dense_gqa_core(q, k, v, cfg: AttnConfig, positions, cache):
    """Write the new K/V rows into a dense or ring-buffer cache and attend
    over it: the four cases of the JAX package's ``_gqa_attention``.

    * ``pos`` a scalar (static batch, every row in lockstep): the dense
      cache takes the chunk at ``pos`` with ``dynamic_update_slice``'s
      clamp of the start; the ring takes row ``(pos + j) % window``;
    * ``pos [B]`` per slot (serving): the rows ``pos[b] + j`` of each slot,
      modulo the ring's size for a ring; dense rows past the cache are
      dropped.  Keys at or past a slot's new length are masked, so rows a
      previous occupant left behind stay invisible.

    A chunk longer than the ring keeps its last ``size`` rows, as the JAX
    scatter's in-order writes leave them (the static loop's lossy one-shot
    prefill past the window).  Returns (output, new cache)."""
    B, S = q.shape[0], q.shape[1]
    pos = cache["pos"]
    size = cache["k"].shape[1]
    cdt = cache["k"].dtype
    kw, vw = _cache_write(k, cdt), _cache_write(v, cdt)
    idx = torch.arange(S, dtype=torch.int32, device=q.device)
    if cfg.window and S > size:
        kw, vw, idx = kw[:, S - size:], vw[:, S - size:], idx[S - size:]
    rows, nxt = _chunk_rows(pos, idx, S, size, ring=bool(cfg.window))
    if cfg.window:
        rows = rows % size
        k_pos = _ring_positions(nxt, size)
    else:
        k_pos = _visible_rows(nxt, size, q.device)
    ck, cv = _put_rows(cache["k"], rows, kw), _put_rows(cache["v"], rows, vw)
    o = sdpa(q, _cache_read(ck, q.dtype), _cache_read(cv, q.dtype), positions,
             k_pos.expand(B, size), cfg.window)
    return o, {"k": ck, "v": cv, "pos": pos + S}


def _gqa_attention(p, x, cfg: AttnConfig, positions, cache, odin, tables=None,
                   spec_decode: bool = False, q_lens=None, q_decode=None, pos3d=None):
    B, S, _ = x.shape
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = reshape(linear(x, p["q"], odin), B, S, H, D)
    k = reshape(linear(x, p["k"], odin), B, S, Hkv, D)
    v = reshape(linear(x, p["v"], odin), B, S, Hkv, D)
    if cfg.rope == "mrope":
        if pos3d is None:
            # text-only rows and decode steps: M-RoPE at (t, t, t)
            pos3d = positions[..., None].expand(B, S, 3)
        q = apply_mrope(q, pos3d, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, pos3d, cfg.mrope_sections, cfg.rope_theta)
    elif cfg.rope == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if cache is None:
        o = sdpa(q, k, v, positions, positions, cfg.window)
        new_cache = None
    elif "k_pool" in cache:
        o, new_cache = _paged_gqa_core(q, k, v, cfg, positions, cache, tables,
                                       spec_decode=spec_decode, q_lens=q_lens,
                                       q_decode=q_decode)
    else:
        o, new_cache = _dense_gqa_core(q, k, v, cfg, positions, cache)
    o = reshape(o, B, S, H * D)
    return linear(o, p["o"], odin), new_cache


# ---------------------------------------------------------------------------
# multi-head latent attention (DeepSeek-V3)
# ---------------------------------------------------------------------------

def mla_decompress_attend(p, q_nope, q_rope, c_kv, k_rope, cfg: AttnConfig,
                          positions, k_pos, odin=None):
    """Decompress latent rows ``c_kv [B, Sk, r]`` through ``k_up``/``v_up``
    into per-head ``K_nope`` and ``V``, append the shared ``k_rope [B, Sk,
    qk_rope_dim]`` to every head's key and attend with the plain ``sdpa``
    core (scale ``1/sqrt(qk_nope + qk_rope)``).  The reference decompresses
    the whole cache every forward; absorbing ``k_up`` into the query would
    not, and is a speed-up the reference lacks.  Returns ``[B, S, H,
    v_head_dim]``."""
    B, H = q_nope.shape[0], cfg.n_heads
    if is_dtensor(q_nope) and q_nope.shape[1] == 1 and _seq_dims(c_kv):
        return _mla_flash_decode(p, q_nope, q_rope, c_kv, k_rope, cfg, positions, k_pos, odin)
    k_nope = reshape(linear(c_kv, p["k_up"], odin), B, -1, H, cfg.qk_nope_dim)
    v = reshape(linear(c_kv, p["v_up"], odin), B, -1, H, cfg.v_head_dim)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(*k_nope.shape[:3], cfg.qk_rope_dim)],
                  dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    return sdpa(q, k, v, positions, k_pos, cfg.window)


def _mla_flash_decode(p, q_nope, q_rope, c_kv, k_rope, cfg: AttnConfig, positions, k_pos,
                      odin=None):
    """MLA's decode over a sequence-sharded latent cache: each rank
    decompresses its own latent rows (``k_up``/``v_up`` gathered whole, the
    weights' collectives) and attends over them; the partials are combined
    as ``_flash_decode`` combines them."""
    from torch.distributed.tensor import Replicate

    mesh = c_kv.device_mesh
    H = cfg.n_heads
    whole = lambda w: to_block(w, mesh, (Replicate(),) * mesh.ndim, c_kv.placements)
    with collective_scope("weights"):
        k_up, v_up = whole(p["k_up"]), whole(p["v_up"])
    kr = to_block(k_rope, mesh, tuple(c_kv.placements))

    def kv_local(c):
        Bl, Sl = c.shape[0], c.shape[1]
        k_nope = linear(c, k_up, odin).reshape(Bl, Sl, H, cfg.qk_nope_dim)
        v = linear(c, v_up, odin).reshape(Bl, Sl, H, cfg.v_head_dim)
        k = torch.cat([k_nope, kr[:, :, None, :].expand(Bl, Sl, H, cfg.qk_rope_dim)], dim=-1)
        return k, v

    q = torch.cat([q_nope, q_rope], dim=-1)
    return _flash_decode(q, c_kv, None, positions, k_pos, cfg.window, kv_local=kv_local)


def _mla_attention(p, x, cfg: AttnConfig, positions, cache, odin):
    """DeepSeek-V3 multi-head latent attention with the compressed cache:
    low-rank Q (``q_down``, its norm, ``q_up``) or one ``q`` projection; the
    latent ``c_kv`` normed and ``k_rope`` rotated *before* they are cached.
    The latent rows are written as the dense GQA rows are (a scalar ``pos``
    with ``dynamic_update_slice``'s start clamp, or per slot with rows past
    the cache dropped; int8 through ``_cache_write``), out of place, then
    the whole cache is decompressed and attended
    (:func:`mla_decompress_attend`).  Both norms take ``rmsnorm``'s default
    eps, as the reference's do."""
    B, S, _ = x.shape
    H = cfg.n_heads
    qk_dim = cfg.qk_nope_dim + cfg.qk_rope_dim
    if "q_down" in p:
        cq = rmsnorm(linear(x, p["q_down"], odin), p["q_norm"])
        q = reshape(linear(cq, p["q_up"], odin), B, S, H, qk_dim)
    else:
        q = reshape(linear(x, p["q"], odin), B, S, H, qk_dim)
    q_nope = q[..., :cfg.qk_nope_dim]
    q_rope = apply_rope(q[..., cfg.qk_nope_dim:], positions, cfg.rope_theta)

    kv = linear(x, p["kv_down"], odin)
    c_kv = rmsnorm(kv[..., :cfg.kv_lora_rank], p["kv_norm"])
    k_rope = apply_rope(kv[:, :, None, cfg.kv_lora_rank:], positions, cfg.rope_theta)[:, :, 0]

    if cache is None:
        new_cache = None
        o = mla_decompress_attend(p, q_nope, q_rope, c_kv, k_rope, cfg, positions, positions,
                                  odin)
    else:
        o, new_cache = _mla_cache_core(p, q_nope, q_rope, c_kv, k_rope, cfg, positions, cache,
                                       odin, x.dtype)
    return linear(reshape(o, B, S, H * cfg.v_head_dim), p["o"], odin), new_cache


@obs.ranged("attn/core")
def _mla_cache_core(p, q_nope, q_rope, c_kv, k_rope, cfg: AttnConfig, positions, cache,
                    odin, dtype):
    """MLA's cache path: write the chunk's latent rows ``c_kv [B, S, r]``
    and ``k_rope`` into the cache (read back in ``dtype``), then decompress
    and attend over the whole cache.  Returns (output, new cache)."""
    B, S = c_kv.shape[0], c_kv.shape[1]
    pos = cache["pos"]
    size = cache["c_kv"].shape[1]
    cdt = cache["c_kv"].dtype
    idx = torch.arange(S, dtype=torch.int32, device=c_kv.device)
    rows, nxt = _chunk_rows(pos, idx, S, size)
    c_kv_q = _put_rows(cache["c_kv"], rows, _cache_write(c_kv, cdt))
    k_rope_q = _put_rows(cache["k_rope"], rows, _cache_write(k_rope, cdt))
    k_pos = _visible_rows(nxt, size, c_kv.device).expand(B, size)
    new_cache = {"c_kv": c_kv_q, "k_rope": k_rope_q, "pos": pos + S}
    o = mla_decompress_attend(p, q_nope, q_rope, _cache_read(c_kv_q, dtype),
                              _cache_read(k_rope_q, dtype), cfg, positions, k_pos, odin)
    return o, new_cache


def attention(p, x, cfg: AttnConfig, positions=None, cache=None, odin=None,
              tables=None, spec_decode: bool = False, q_lens=None, q_decode=None,
              pos3d=None):
    """Returns (output [B,S,d_model], new_cache).  ``tables`` are the per-slot
    block tables of the paged serving cache (ignored by dense and MLA
    caches); ``spec_decode``, ``q_lens`` and ``q_decode`` as in
    :func:`_paged_gqa_core` (a dense or MLA cache already attends an S-token
    tile with decode semantics).  ``pos3d [B, S, 3]``: the (t, h, w)
    position ids of an M-RoPE layer (ignored by every other layer)."""
    B, S, _ = x.shape
    if q_lens is not None and (cache is None or "k_pool" not in cache):
        raise ValueError("q_lens (mixed dispatch) requires a paged GQA cache")
    if positions is None:
        start = cache["pos"] if cache is not None else torch.zeros((), dtype=torch.int32)
        if start.ndim == 1:                     # per-slot positions [B]
            start = start[:, None]
        positions = (start + torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
                     + torch.zeros((B, 1), dtype=torch.int32, device=x.device))
    if cfg.kind == "mla":
        return _mla_attention(p, x, cfg, positions, cache, odin)
    return _gqa_attention(p, x, cfg, positions, cache, odin, tables,
                          spec_decode=spec_decode, q_lens=q_lens, q_decode=q_decode,
                          pos3d=pos3d)
