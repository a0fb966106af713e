"""On-card smoke run of the PyTorch/CUDA port (run from the repository root:
``python3 chip_smoke.py``; needs one CUDA card, no arguments).

Phases, each fatal on failure:

1. report the card (``nvidia-smi`` name and power limit), the torch/CUDA
   versions, and build the port's four CUDA kernels from ``src/`` with
   ``nvcc``, one process each, in parallel;
2. hold each kernel against its plain PyTorch version on the card at the
   shapes its paths give it, and time kernel, plain version and the library
   yardstick against the kernel's bound (device times by CUDA-graph
   replay for every kernel): ``paged_attn`` (split over
   the page axis, then a combine pass) at the serving path's shapes (decode,
   and the speculative phase's 5-token verify tile, at phi4's 3 query heads
   a KV head and at qwen3-moe's 16, whose launch plan cuts a head's rows
   into 4 and 20 chunks, hymba's global layers' decode at G = 5, D = 64
   over 1536-1600 tokens, 2 chunks of 3 rows, nemotron-4-15b's G = 6
   at D = 128, 2 and 10 chunks of 3 rows, musicgen-medium's MHA decode at
   G = 1, D = 64, one chunk of 1 row, and qwen2-vl-2b's G = 6 over 2 KV
   heads, 2 and 10 chunks), one long slot, 64
   slots that the plan does not split, and window and verify cases whose
   plan leaves empty splits; ``act_pool`` bit for bit
   through its own entry point on CNN1's and CNN2's conv maps at batch 64
   and a VGG-scale map in every activation and pooling kind, plus pools
   of 3 to 7 (5 to 7 run the kernel's loop for any pool size), 1 to 65
   channels, odd output widths, an input at an odd storage offset, maps
   below one CTA and over several grid-stride passes, the whole tanh
   domain, average ties and the int32 extremes, the launcher's grid equal
   to ``launch_plan``'s in every case, timed in every kind on each map with
   its share of the bytes bound and beside the per-kernel floor; ``sc_mac``
   bit for bit at the kernel bench's shape, every CNN1 layer at an
   evaluation batch of 64 in every tiling the CNN path runs (full tree,
   blocks of 32 and 8), CNN2's conv0, a full tree at K=3000 (one tree of
   4096 leaves, past the JAX wrapper's 2048) and a 512x4096x512 layer,
   each with its launch plan (tile, K splits) and two bounds (the MUX tree
   as an OR of masked leaves, and as drawn), then 13 untimed variants
   (int32 clamps, 1-, 4- and 32-word streams, 257 levels, short trees);
   ``odin_linear`` at phi4-mini-3.8b's seven projections (sc: kernel
   route == plain route at 2, 8, 16 and 32 rows, the row counts of the sc
   serving path; int8: card == CPU at 8 rows; bit for bit; ``sc_mac`` timed
   at each projection at 2 rows, the sc decode step's, and 8; the kernels
   line gives these times with their bounds and plans); ``int8_mm`` bit for bit at 128x256x128,
   8x3072x8192, 257x1000x129 and 4096^3, with ``torch._int_mm`` timed as its
   yardstick on W as given and on W stored transposed; ``int_matmul`` (float64
   on the card) against the CPU's int32 matmul;
3. check four small models end to end, dense, MoE, relu² at G = 6 and
   the deepseek-v3 smoke config (MLA + MoE): the engine on the card (CUDA
   kernel) and on the CPU (plain path) must emit the same greedy tokens in
   float32;
4. serve full-width phi4-mini-3.8b (all 32 layers, random bf16 weights from a
   seeded generator) through the port's ServingEngine with its defaults
   (mixed dispatch, prefix sharing) and show that every forward that carried
   a decode row or a mixed tile went through the kernel; then a short run
   with mixed dispatch off whose streams must equal the first run's, except
   where they part at a near tie of the logits (reported, see
   ``check_divergence``); then 16 requests sharing a prompt prefix in a
   tight pool with a swap tier (prefix hits, copy-on-write forks, swap
   preemptions), served with horizon 1 and horizon 4, whose streams are held
   against each other the same way; then a profile of plain decode steps;
   then n-gram speculative decoding (K = 4, horizon 4) on the same traffic,
   whose streams must equal the spec-off run's the same way and whose
   verify tiles launch ``paged_attention`` at Q = 5, and on repetitive
   traffic (prompts tiled from an 8-token pattern) against a spec-off run
   at horizon 4, with accept rates and decode tokens/s; then the asyncio
   front door (mixed dispatch off) over 8 concurrent streams with a queue
   overflow and a client disconnect, held against ``engine.run``, and one
   ``POST /generate`` over the SSE server on 127.0.0.1;
5. serve the same model in ODIN's int8 mode (8 prompts of 512 tokens, 32
   greedy tokens; decode profile; agreement with exact mode reported) and
   sc mode (2 prompts of 16 tokens, 4 greedy tokens; every forward launches
   ``sc_mac`` 4 rails x 7 projections x 32 layers times; seconds per
   dispatch; sc_mac's share of a decode step's device time);
6. the guarded decode step: a nan_logits fault plan quarantines exactly one
   request while the co-batched streams keep the fault-free run's; then a
   generated chaos plan with the degradation ladder on runs to completion
   with every request terminal;
7. the dense KV cache: full-width phi4-mini with ``paged=False`` on the
   serving phase's traffic (no ``paged_attention`` launch), and the static
   loop (``serve_static``) on the same prompts, both held against the paged
   run's streams (partings only at reported near ties);
8. Hymba: hymba-1.5b's widths over 2 of its layers (one global, one
   window) on the card equal to the CPU plain path (streams and logits,
   float32); then hymba-1.5b at every width and all 32 layers (random bf16
   weights): 8 prompts of 1536 tokens past the 1024-token window, 64 greedy
   tokens, ``paged_attention`` launched once a decode-carrying forward by
   each of the three global layers; its first 2 prompts held against
   ``paged=False``, a swap pressure run and horizon 4; a decode profile with the SSM's and
   ``paged_attn``'s shares; the per-token cost of the SSM scan at prefill;
9. serve qwen3-moe-235b-a22b at every published width over 8 of its 94
   layers (random bf16 weights, the router float32): the serving phase's 8
   prompts of 512 tokens with 32 greedy tokens (mixed dispatch, prefix
   sharing), 16 with mixed dispatch off held against them, n-gram
   speculation (K = 4, horizon 4) on repetitive traffic held against a
   spec-off run, every decode-carrying forward launching
   ``paged_attention`` once per layer; then a decode profile with the
   expert products' and ``paged_attn``'s shares of the device time;
10. deepseek-v3-671b's widths over 1 dense and 1 MoE layer, float32: the
   logits of a prefill and 3 decode steps on the card equal to the CPU
   plain path, and moved past the bound when the routed experts' output is
   zeroed; then serve deepseek-v3-671b at every published width over its
   3 dense and 2 of its 58 MoE layers with the MTP subtree (random bf16 weights, 54.6 GB):
   multi-head latent attention over the compressed latent cache, dense per
   slot (no ``paged_attention`` launch on any run); the serving phase's 8
   prompts of 512 tokens with 32 greedy tokens, a swap-pressure run at
   horizon 4, n-gram speculation (K = 4, horizon 4) on repetitive traffic
   against a spec-off run, and the static loop, each held against its
   base run; a decode profile with the latent decompression's and the
   expert products' shares;
11. xLSTM: xlstm-350m's widths over 1 mLSTM + 1 sLSTM layer, float32:
   the logits of a 2 x 600-token prefill (the chunkwise form over a padded
   second chunk) and 3 decode steps on the card within ``XLSTM_CARD_TOL``
   of the CPU plain path, and moved past it when the sLSTM's ``out`` is
   zeroed; then xlstm-350m at every width and all 24 layers (random bf16
   weights, 229.09 M parameters): 8 prompts of 2048 tokens + 64, held
   against horizon 4 and swap pressure (on 2 of them; the cell state in
   the swap ticket); the static loop held against the engine in float32 (2
   prompts); one prompt of 16,384 tokens + 32 beside it (prefill
   ms a token, peak memory); a decode profile with the mLSTM's and sLSTM's
   shares; no ``paged_attention`` launch on any xLSTM path;
12. nemotron-4-15b at every width and all 32 layers (random bf16 weights,
   31.3 GB): 8 prompts of 512 tokens + 32 with the engine's defaults,
   ``paged_attention`` at G = 6 once a layer a decode-carrying forward; a
   decode profile with ``paged_attn``'s share;
13. MusicGen: musicgen-medium's widths over 2 of its layers, float32: the
   logits ``[B, S, 4, V]`` of a prefill and 3 decode frames on the card
   within ``MUSICGEN_CARD_TOL`` of the CPU plain path, moved past it when
   the head's or the embedding's codebook axis is rolled, and the engine's
   frame streams card == CPU; then musicgen-medium at every width and all
   48 layers (random bf16 weights, 2.77 GB): 8 prompts of [4, 512] tokens
   + 32 greedy frames with the engine's defaults, ``paged_attention`` at
   G = 1, D = 64 once a layer a decode-carrying forward; horizon 4, swap
   pressure and the static loop on its first 2 prompts held against it
   frame by frame; a decode profile;
14. Qwen2-VL: qwen2-vl-2b's widths over 2 of its layers, float32, a prefill
   with the vision stub's extras and 3 decode steps card == CPU within
   ``VLM_CARD_TOL``, moved past it by reversed M-RoPE sections or RoPE at
   (t, t, t), and the engine's streams of requests with extras card ==
   CPU; then qwen2-vl-2b at every width and all 28 layers (3.55 GB): 8
   requests of 448 tokens with extras (100 patches) + 32 through the
   separate prefill and 8 text-only requests of 512 + 32 through mixed
   dispatch, ``paged_attention`` at G = 6 over 2 KV heads once a layer a
   decode-carrying forward; recompute pressure and the static loop on the
   first 2 extras requests held against the base run; a decode profile;
15. run the paper's experiment at full width (``launch/odin_inference``):
   train CNN1 for 300 steps, evaluate 512 held-out images in fp32, int8,
   sc hybrid/32, sc hybrid/8 and the sc full tree under the JAX suite's
   accuracy thresholds, count ``sc_mac`` launches (rails x MAC layers x
   forwards, a warm-up forward included), profile one forward of each
   mode, and hold one batch's logits in every ODIN mode on the card equal
   to the CPU plain path bit for bit;
16. run the kernel bench entry point (``launch/kernel_bench``), the path of
   ``int8_mm``, and count its launches;
17. training, card against CPU (``train_card``): one train step (loss,
   gradients, AdamW) of each of the ten smoke configs in float32 and of
   phi4-mini-3.8b's widths over 2 layers with ``remat="full"``, loss,
   ``grad_norm`` and every gradient leaf within ``TRAIN_CARD_TOL``; labels
   shifted by one position move the loss past it;
18. phi4-mini-3.8b trained at every width and all 32 layers (``train_phi4``,
   bf16 weights, ``remat="full"``, 4 x 512 tokens a step), 6 steps with
   float32 and 6 with int8 AdamW moments: step ms, tokens/s, share of the
   bf16 peak, peak memory, the loss curve, a profile of one step with the
   AdamW update's share;
19. xlstm-350m trained at every width and all 24 layers through the
   training CLI (``train_xlstm``, 8 x 256 tokens, int8 moments): a crash
   at step 4 without a checkpoint (exit 137), a ``--resume`` run to step 6
   whose checkpoint equals bit for bit the state of a straight in-process
   ``train_loop``, step ms and checkpoint bytes.  No kernel is launched on a training path (exact
   mode): each kernel's count is read there and is 0.

Each phase's seconds are printed.

Each path's launch counts are set to 0 just before it runs and read just
after; the kernels line gives each kernel's total and, where it has more
than one path, the count of each.

The last two lines of stdout are ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``.  ``--phases paged_attn,act_pool,sc_mac,
odin_linear,serve_sc,serve_spec,frontdoor,serve_moe,serve_dense,hymba_card,
serve_hybrid,mla_card,serve_mla,xlstm_card,serve_xlstm,serve_nemotron,
musicgen_card,vlm_card,serve_musicgen,serve_vlm,train_card,train_phi4,
train_xlstm`` (any subset) runs only those
checks, for a focused call, and prints no kernels
line.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12              # dense bf16 tensor-core peak
F32_FLOPS = 67e12                # float32 outside the tensor cores
INT8_OPS = 1979e12               # dense int8 tensor-core peak
# 32-bit integer/logic lane operations a second: 132 SMs x 64 INT32 lanes
# x 1.98 GHz boost (the 67 TFLOP/s float32 peak is 132 x 128 lanes x 2 x
# the same clock; Hopper has half as many INT32 lanes as FP32 lanes)
INT32_OPS = 132 * 64 * 1.98e9
# |kernel - plain| <= atol + rtol·|plain|, elementwise.  float32: the JAX
# suite's bound.  bfloat16: kernel and plain version both accumulate in
# float32 and round once to bf16, so they may part by one bf16 ulp, which is
# at most 2^-7·|x|; atol covers outputs near 0.
TOL = {torch.float32: (3e-5, 0.0),
       torch.bfloat16: (1e-5, 2.0 ** -7)}


def log(*a):
    print(*a, flush=True)


def free_device_memory():
    """Return the memory of dropped weights to the card: the engines that
    held them sit in reference cycles (``counting`` wraps their methods in
    closures over themselves), which only the collector frees."""
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def patched(module, name, wrap):
    """Replaces ``module.name`` by ``wrap(original)`` while entered: the
    port calls these functions through their module, so the wrapper sees
    every call (chip_smoke's instrumentation; the port has none)."""
    fn = getattr(module, name)
    setattr(module, name, wrap(fn))
    try:
        yield
    finally:
        setattr(module, name, fn)


def ranged(module, name):
    """Wraps every call of ``module.name`` in a profiler range of that name."""
    def wrap(fn):
        def inner(*a, **k):
            with torch.profiler.record_function(name):
                return fn(*a, **k)
        return inner
    return patched(module, name, wrap)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, after a warm-up."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, reps: int = 3) -> float:
    """Mean device time of one ``fn()`` call without the host's launch
    overhead: ``iters`` calls captured into one CUDA graph (after a warm-up
    on a side stream), the graph replayed ``reps`` times between two
    events.  For kernels whose device time is below the Python wrapper's
    time a call, which ``cuda_ms`` would measure instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * iters)
    del graph
    return ms


def kernel_us(fn, calls: int = 20) -> dict:
    """Device time a call of each kernel that ``fn()`` launches, by name,
    from the profiler over ``calls`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: (getattr(e, "self_device_time_total", None)
                         or getattr(e, "self_cuda_time_total", 0)) / calls
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


# ---------------------------------------------------------------------------
# phase 2: paged attention kernel vs its plain version
# ---------------------------------------------------------------------------

def attn_case(name, *, B=8, Q=1, H=24, Hkv=8, D=128, bs=16, P=64, window=0,
              q_dtype=torch.bfloat16, kv="bf16", special=None, seed=0, copies=1,
              lengths=None):
    """Inputs for one kernel check; ``copies`` distinct pools so that timed
    launches cycle through more bytes than the 50 MB L2 holds.  Lengths
    spread from Q to P·bs unless given as a (low, high) range."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    N = B * P + 1
    q = (torch.randn((B, Q, H, D), generator=g, device=dev) * 0.5).to(q_dtype)
    pools = []
    for _ in range(copies):
        if kv == "int8":
            kp = torch.randint(-127, 128, (N, bs, Hkv, D), generator=g, device=dev,
                               dtype=torch.int32).to(torch.int8)
            vp = torch.randint(-127, 128, (N, bs, Hkv, D), generator=g, device=dev,
                               dtype=torch.int32).to(torch.int8)
        else:
            dt = torch.bfloat16 if kv == "bf16" else torch.float32
            kp = (torch.randn((N, bs, Hkv, D), generator=g, device=dev) * 0.5).to(dt)
            vp = (torch.randn((N, bs, Hkv, D), generator=g, device=dev) * 0.5).to(dt)
        pools.append((kp, vp))
    tables = torch.randperm(N - 1, generator=g, device=dev)[:B * P].reshape(B, P).int()
    rng = np.random.default_rng(seed)
    lo, hi = lengths if lengths is not None else (Q, P * bs)
    lengths = np.linspace(lo, hi, B).astype(np.int32)          # spread up to P·bs
    rng.shuffle(lengths)
    if special == "zero_len":
        lengths[0] = 0
        lengths[1] = 1                      # rows of queries 0..Q-2 see no key
    lengths = torch.as_tensor(lengths, device=dev)
    return dict(name=name, q=q if Q > 1 else q[:, 0].contiguous(), pools=pools,
                tables=tables, lengths=lengths, window=window, Q=Q, G=H // Hkv,
                kv_scale=16.0 if kv == "int8" else None, special=special)


def split_report(c):
    """The wrapper's split plan for a case (from shapes alone) and, counted
    here on the host from this case's lengths, how many of its CTAs' page
    ranges hold no visible key."""
    from repro_torch.kernels.paged_attn.ops import sm_count, split_plan
    kp = c["pools"][0][0]
    bs, Hkv = kp.shape[1], kp.shape[2]
    B, P = c["tables"].shape
    pages, n_splits = split_plan(B, Hkv, P, bs, sm_count(0))
    empty = 0
    for L in c["lengths"].tolist():
        hi = min(P, -(-L // bs)) if L > 0 else 0
        t = L - c["Q"] - c["window"] + 1
        lo = t // bs if c["window"] and t > 0 else 0
        empty += sum(min(hi, (s + 1) * pages) <= max(lo, s * pages) for s in range(n_splits))
    return {"pages_per_split": pages, "n_splits": n_splits, "ctas": B * Hkv * n_splits,
            "empty_splits": empty * Hkv, "kernels_per_call": 1 if n_splits == 1 else 2}


def tol_excess(out, ref):
    """Per-slot max of |out - ref| / (atol + rtol·|ref|): within tolerance
    where it is <= 1."""
    atol, rtol = TOL[ref.dtype]
    ref = ref.float()
    e = (out.float() - ref).abs() / (atol + rtol * ref.abs())
    return e.reshape(e.shape[0], -1).amax(dim=1)


def live_bytes_and_ops(c):
    """Bytes the function must move — every visible K/V row once, and q,
    out, tables and lengths once, returned apart — and its multiply-adds
    (QK and PV over visible keys)."""
    kp = c["pools"][0][0]
    _, bs, Hkv, D = kp.shape
    q, Q, G, window = c["q"], c["Q"], c["G"], c["window"]
    rows = 0
    ops = 0
    for L in c["lengths"].tolist():
        lo = 0 if not window else max(0, L - Q - window + 1)
        rows += max(0, L - lo)
        for j in range(Q):
            qp = L - Q + j
            vis = max(0, min(qp + 1, L) - (max(0, qp - window + 1) if window else 0))
            ops += 4 * G * D * vis * Hkv
    kv_bytes = 2 * rows * Hkv * D * kp.element_size()
    io = 2 * q.numel() * q.element_size() + c["tables"].numel() * 4 + c["lengths"].numel() * 4
    return kv_bytes, io, ops


def library_call(c):
    """One PyTorch call computing the same function: SDPA over the K/V
    gathered from the pool (the gather is outside the timed call)."""
    import torch.nn.functional as F
    kp, vp = c["pools"][0]
    B, P = c["tables"].shape
    _, bs, Hkv, D = kp.shape
    q4 = c["q"] if c["Q"] > 1 else c["q"][:, None]
    qh = q4.transpose(1, 2)                                        # [B, H, Q, D]
    k = kp[c["tables"].long()].reshape(B, P * bs, Hkv, D).transpose(1, 2).to(qh.dtype)
    v = vp[c["tables"].long()].reshape(B, P * bs, Hkv, D).transpose(1, 2).to(qh.dtype)
    pos = torch.arange(P * bs, device="cuda")
    qpos = c["lengths"][:, None].long() - c["Q"] + torch.arange(c["Q"], device="cuda")
    mask = pos[None, None, :] <= qpos[..., None]                   # [B, Q, S]
    if c["window"]:
        mask &= pos[None, None, :] > qpos[..., None] - c["window"]
    mask = mask[:, None]
    try:
        F.scaled_dot_product_attention(qh, k, v, attn_mask=mask, enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(qh, k, v, attn_mask=mask,
                                                      enable_gqa=True)
    except TypeError:                          # torch without enable_gqa
        G = qh.shape[1] // Hkv
        ke, ve = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
        return lambda: F.scaled_dot_product_attention(qh, ke, ve, attn_mask=mask)


def check_paged_attn():
    from repro_torch.kernels.paged_attn import paged_attention, paged_attn_cuda
    from repro_torch.kernels.paged_attn.ops import launch_plan
    from repro_torch.kernels.paged_attn.ref import paged_attn_ref

    cases = [
        attn_case("decode_bf16", copies=4),
        attn_case("decode_int8_pool", kv="int8", seed=1),
        attn_case("window_bf16", window=200, seed=2),
        attn_case("verify_q3_bf16", Q=3, seed=3),
        attn_case("zero_len_masked_f32", Q=3, q_dtype=torch.float32, kv="f32",
                  special="zero_len", seed=4),
        attn_case("window_q3_int8_f32", Q=3, q_dtype=torch.float32, kv="int8",
                  window=40, D=64, seed=5),
        # the serving phase's decode: 8 slots of 512-576 tokens
        attn_case("decode_serving_bf16", lengths=(512, 576), copies=4, seed=6),
        # one slot of 1024 tokens: 8 CTAs (one a kv-head) in the unsplit design
        attn_case("long_one_slot_bf16", B=1, lengths=(1024, 1024), copies=4, seed=7),
        # 64 slots of 16 pages: the plan does not split (n_splits == 1)
        attn_case("no_split_b64_bf16", B=64, P=16, copies=4, seed=8),
        # the speculative serving phase's verify tile: K = 4 drafts + the
        # pending token at the serving phase's lengths (Q·G = 15 rows a head)
        attn_case("verify_q5_serving_bf16", Q=5, lengths=(512, 576), copies=4, seed=9),
        # qwen3-moe-235b-a22b's serving shapes: 64 query heads over 4 KV
        # heads (G = 16), decode and the Q = 5 verify tile (80 rows a head);
        # 8 pools, as the live K/V of one is half phi4's
        attn_case("decode_qwen3_g16_bf16", H=64, Hkv=4, lengths=(512, 576), copies=8,
                  seed=10),
        attn_case("verify_q5_qwen3_g16_bf16", Q=5, H=64, Hkv=4, lengths=(512, 576),
                  copies=8, seed=11),
        # hymba-1.5b's global layers at the hybrid serving phase's decode: 25
        # query heads over 5 KV heads (G = 5) of 64, 8 slots of 1536-1600
        # tokens in 100 pages of 16
        attn_case("decode_hymba_g5_d64_bf16", H=25, Hkv=5, D=64, P=100,
                  lengths=(1536, 1600), copies=8, seed=12),
        # nemotron-4-15b's serving shapes: 48 query heads over 8 KV heads
        # (G = 6) of 128, decode and the Q = 5 verify tile (30 rows a head),
        # 8 slots of 512-576 tokens
        attn_case("decode_nemotron_g6_bf16", H=48, Hkv=8, lengths=(512, 576), copies=4,
                  seed=13),
        attn_case("verify_q5_nemotron_g6_bf16", Q=5, H=48, Hkv=8, lengths=(512, 576),
                  copies=4, seed=14),
        # musicgen-medium's decode: 24 heads over 24 KV heads (MHA, G = 1) of
        # 64, 8 slots of 512-576 tokens
        attn_case("decode_musicgen_g1_d64_bf16", H=24, Hkv=24, D=64, lengths=(512, 576),
                  copies=4, seed=15),
        # qwen2-vl-2b's serving shapes: 12 query heads over 2 KV heads (G = 6)
        # of 128, decode and the Q = 5 verify tile; 16 pools, as the live K/V
        # of one is 4.5 MB
        attn_case("decode_qwen2vl_g6_hkv2_bf16", H=12, Hkv=2, lengths=(512, 576),
                  copies=16, seed=16),
        attn_case("verify_q5_qwen2vl_g6_hkv2_bf16", Q=5, H=12, Hkv=2, lengths=(512, 576),
                  copies=16, seed=17),
    ]
    # row chunks of the launch plan, each re-reading its split's pages
    expect_chunks = {"decode_qwen3_g16_bf16": 4, "verify_q5_qwen3_g16_bf16": 20,
                     "decode_hymba_g5_d64_bf16": 2, "decode_nemotron_g6_bf16": 2,
                     "verify_q5_nemotron_g6_bf16": 10, "decode_musicgen_g1_d64_bf16": 1,
                     "decode_qwen2vl_g6_hkv2_bf16": 2, "verify_q5_qwen2vl_g6_hkv2_bf16": 10}
    # cases whose plan must leave CTAs with no visible key (exact empty partials)
    need_empty = ("window_bf16", "verify_q3_bf16", "zero_len_masked_f32", "window_q3_int8_f32")
    lines = {}
    for c in cases:
        kp, vp = c["pools"][0]
        kw = dict(window=c["window"], kv_scale=c["kv_scale"])
        out = paged_attention(c["q"], kp, vp, c["tables"], c["lengths"], **kw)
        torch.cuda.synchronize()
        # plain version on the same packed tile
        q4 = c["q"] if c["Q"] > 1 else c["q"][:, None]
        B, Q, H, D = q4.shape
        Hkv, G = kp.shape[2], c["G"]
        qt = q4.reshape(B, Q, Hkv, G, D).permute(0, 2, 1, 3, 4).reshape(B, Hkv, Q * G, D)

        def plain_out(lengths):
            r = paged_attn_ref(qt, kp, vp, c["tables"], lengths, q_len=Q, **kw)
            r = r.reshape(B, Hkv, Q, G, D).permute(0, 2, 1, 3, 4).reshape(B, Q, H, D)
            return r if c["Q"] > 1 else r[:, 0]

        ref = plain_out(c["lengths"])
        err = (out.float() - ref.float()).abs().max().item()
        excess = tol_excess(out, ref).max().item()
        if not (math.isfinite(err) and excess <= 1.0):
            raise AssertionError(f"paged_attn {c['name']}: |kernel - plain| exceeds "
                                 f"{TOL[ref.dtype]} (max abs {err:.3e}, {excess:.2f}x)")
        # the tolerance must be tight enough to see one key too few in any slot
        L = c["lengths"]
        short = tol_excess(plain_out(torch.where(L >= 1, L - 1, L + 1)), ref)
        if short.min().item() <= 1.0:
            raise AssertionError(f"paged_attn {c['name']}: tolerance {TOL[ref.dtype]} "
                                 f"passes a one-key length error: {short.tolist()}")
        if c["special"] == "zero_len":
            if out[0].abs().max().item() != 0.0 or out[1, :Q - 1].abs().max().item() != 0.0:
                raise AssertionError("paged_attn: zero-length slot / masked rows not exactly 0")
        kv_bytes, io_bytes, ops = live_bytes_and_ops(c)
        nbytes = kv_bytes + io_bytes
        peak = BF16_FLOPS if c["q"].dtype == torch.bfloat16 else F32_FLOPS
        bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / peak) * 1e3
        bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / peak else "operations"
        plan = split_report(c)
        if c["name"] in need_empty and plan["empty_splits"] == 0:
            raise AssertionError(f"paged_attn {c['name']}: the plan left no empty split {plan}")
        if c["name"].startswith("no_split") and plan["n_splits"] != 1:
            raise AssertionError(f"paged_attn {c['name']}: the plan splits {plan}")
        line = {"case": c["name"], "max_abs_err": err, "atol_rtol": TOL[ref.dtype],
                "max_tol_excess": excess, "one_key_short_min_excess": short.min().item(),
                "bound_ms": bound_ms, "bound_by": bound_by, "live_bytes": nbytes, **plan,
                "launch_plan": launch_plan(Q * G, D, kp.shape[1], kp.element_size(),
                                           plan["pages_per_split"])}
        chunks = line["launch_plan"]["row_chunks"]
        line["kv_bytes_read_by_plan"] = chunks * kv_bytes
        if chunks != expect_chunks.get(c["name"], chunks):
            raise AssertionError(f"paged_attn {c['name']}: {chunks} row chunks, expected "
                                 f"{expect_chunks[c['name']]}")
        if len(c["pools"]) > 1 or c["name"] in ("window_bf16", "verify_q3_bf16"):
            packed = [(qt.contiguous(), kpi, vpi) for kpi, vpi in c["pools"]]
            i = [0]

            def kernel():
                qq, kpi, vpi = packed[i[0] % len(packed)]
                i[0] += 1
                paged_attn_cuda(qq, kpi, vpi, c["tables"], c["lengths"], q_len=Q, **kw)

            def plain():
                qq, kpi, vpi = packed[i[0] % len(packed)]
                i[0] += 1
                paged_attn_ref(qq, kpi, vpi, c["tables"], c["lengths"], q_len=Q, **kw)

            # device time (graph replay), interleaved: plain, kernel, kernel,
            # plain; then the kernel's eager time a call, host included
            p1 = graph_ms(plain, 20)
            k1 = graph_ms(kernel, 100)
            k2 = graph_ms(kernel, 100)
            p2 = graph_ms(plain, 20)
            lib = graph_ms(library_call(c), 100)
            line.update(ms=min(k1, k2), plain_ms=min(p1, p2), library_ms=lib,
                        kernel_ms_runs=[k1, k2], plain_ms_runs=[p1, p2],
                        eager_ms=cuda_ms(kernel, 100), timer="cuda graph replay")
            if c["name"] == "decode_bf16":
                line["kernel_us_by_name"] = kernel_us(kernel)
        lines[c["name"]] = line
        log("paged_attn check:", json.dumps(line))
    return lines


# ---------------------------------------------------------------------------
# phases 3-4: serving
# ---------------------------------------------------------------------------

def small_model_card_vs_cpu():
    """2-layer models with the kernel's head dim, dense and MoE, a 2-layer
    relu² model at nemotron's G = 6 and D = 128, and the deepseek-v3 smoke
    config (MLA + MoE, 3 layers): greedy streams of the engine on the card
    (CUDA kernel; plain PyTorch on the card for MLA) equal those on the CPU
    (plain path), in float32."""
    from repro_torch.configs.base import AttnConfig, BlockConfig, ModelConfig, MoEConfig
    from repro_torch.models import lm, registry
    from repro_torch.nn.module import materialize
    from repro_torch.serving import ServingEngine, WorkloadSpec, make_requests
    from repro_torch.tree import tree_map

    attn = AttnConfig(n_heads=4, n_kv_heads=2, d_head=64)
    blocks = {"dense": BlockConfig(kind="dense", n_layers=2, d_ff=512, attn=attn),
              "moe": BlockConfig(kind="moe", n_layers=2, attn=attn,
                                 moe=MoEConfig(n_experts=8, top_k=2, d_ff=128,
                                               aux_free_bias=False)),
              "relu2_g6": BlockConfig(kind="dense", n_layers=2, d_ff=512, activation="relu2",
                                      attn=AttnConfig(n_heads=12, n_kv_heads=2, d_head=128))}
    spec = WorkloadSpec(n_requests=5, rate=1e9, prompt_buckets=(24, 40), gen_buckets=(8, 20))
    cfgs = {kind: ModelConfig(name=f"smoke-{kind}-d{block.attn.d_head}", d_model=256,
                              vocab=512,
                              kv_dtype="float32", blocks=(block,))
            for kind, block in blocks.items()}
    cfgs["mla"] = registry.get_smoke(MLA_ARCH).with_overrides(kv_dtype="float32")
    for kind, cfg in cfgs.items():
        gen = torch.Generator().manual_seed(0)
        params = tree_map(lambda t: t.float(), materialize(lm.param_spec(cfg), gen, "cpu"))
        streams = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda t: t.to(dev), params)
            eng = ServingEngine(cfg, slots=3, max_len=64, block_size=16, params=p,
                                device=dev, prefill_chunk=16)
            reqs = make_requests(cfg, spec, seed=1)
            eng.run(reqs)
            streams[dev] = {r.rid: [int(np.ravel(t)[0]) for t in r.generated] for r in reqs}
        if streams["cpu"] != streams["cuda"]:
            raise AssertionError(f"small {kind} model: card {streams['cuda']} != "
                                 f"cpu {streams['cpu']}")
        n = sum(len(s) for s in streams["cuda"].values())
        log(f"small {kind} model ({cfg.name}, float32): card == cpu greedy streams, "
            f"{n} tokens")


def load_phi4():
    """Full-width phi4-mini-3.8b (all 32 layers) with random bf16 weights from
    a seeded generator on the card, and eight 512-token prompts."""
    from repro_torch.models import lm, registry
    from repro_torch.nn.module import count_params, materialize

    cfg = registry.get_config("phi4-mini-3.8b")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = materialize(lm.param_spec(cfg), gen, "cuda")
    torch.cuda.synchronize()
    log(f"phi4-mini-3.8b: {count_params(lm.param_spec(cfg)) / 1e9:.3f} B params "
        f"materialized in bf16 on the card in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = list(rng.integers(0, cfg.vocab, size=(8, 512), dtype=np.int32))
    return cfg, params, prompts, rng


class counting:
    """Counts an engine's forwards and the kernels they launch, for one run.

    Wraps the engine's step functions (prefill, plain, mixed and guarded
    decode) and the module-level factories of its fused decode functions
    (horizon and speculation: ``H`` forwards a call), sets every kernel's
    launch count to 0 on entry and reads the counts on exit.
    ``paged_attention``'s launches are also tallied by query tile length
    (1 for decode rows, K+1 for a speculative verify tile) through a
    pass-through of the kernel wrapper; its own count is the one reported.
    ``timed`` records each wrapped dispatch's wall time (synchronised)."""

    def __init__(self, eng, timed=False):
        self.eng, self.timed = eng, timed
        self.forwards = self.prefill_forwards = 0
        self.times = {"_decode": [], "_mixed": [], "_guarded": [], "_prefill": []}
        self.by_q = {}

    def __enter__(self):
        from repro_torch.kernels.paged_attn import ops as paged_ops
        from repro_torch.kernels.paged_attn import paged_attention
        from repro_torch.kernels.sc_mac import sc_mac_cuda
        from repro_torch.serving import engine as engine_mod
        for attr in self.times:
            fn = getattr(self.eng, attr)

            def counted(*a, _fn=fn, _attr=attr, **k):
                if _attr == "_prefill":
                    self.prefill_forwards += 1
                    # a one-token chunk (the tail behind a shared prefix)
                    # takes the decode kernel: (params, caches, tokens, ...)
                    self.forwards += a[2].shape[-1] == 1
                else:
                    self.forwards += 1
                if self.timed:
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                out = _fn(*a, **k)
                if self.timed:
                    torch.cuda.synchronize()
                    self.times[_attr].append(time.perf_counter() - t)
                return out
            setattr(self.eng, attr, counted)
        self._factories = {name: getattr(engine_mod, name) for name in
                           ("make_serving_decode_horizon", "make_serving_spec_horizon")}
        for name, make in self._factories.items():
            def counted_make(cfg_, H, *a, _make=make, **k):
                fn = _make(cfg_, H, *a, **k)

                def step(*aa, **kk):
                    self.forwards += H
                    return fn(*aa, **kk)
                return step
            setattr(engine_mod, name, counted_make)
        self._kernel = paged_ops.paged_attn_cuda

        def tally(*a, _kernel=self._kernel, **k):
            q = k.get("q_len", 1)
            self.by_q[q] = self.by_q.get(q, 0) + 1
            return _kernel(*a, **k)
        paged_ops.paged_attn_cuda = tally
        paged_attention.launches = 0
        sc_mac_cuda.launches = 0
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.paged_attn import ops as paged_ops
        from repro_torch.kernels.paged_attn import paged_attention
        from repro_torch.kernels.sc_mac import sc_mac_cuda
        from repro_torch.serving import engine as engine_mod
        torch.cuda.synchronize()
        self.launches, self.sc_launches = paged_attention.launches, sc_mac_cuda.launches
        paged_ops.paged_attn_cuda = self._kernel
        for name, make in self._factories.items():
            setattr(engine_mod, name, make)
        return False

    def check(self, cfg):
        """Every forward that carried a decode row, a mixed tile, a verify
        tile or a one-token prefill chunk launched ``paged_attention`` once
        per layer on the paged pool: every layer of a fully paged model,
        Hymba's global layers, none with ``paged=False``."""
        from repro_torch.launch.steps import pageable_block
        n = sum(b.n_layers for b in cfg.blocks if pageable_block(b)) if self.eng.paged else 0
        if (n and self.launches <= 0) or self.launches != n * self.forwards:
            raise AssertionError(f"paged_attention launches {self.launches} != "
                                 f"{n} paged layers x {self.forwards} forwards")
        if sum(self.by_q.values()) != self.launches:
            raise AssertionError(f"launches by query length {self.by_q} do not add up "
                                 f"to {self.launches}")


def _token(x):
    """A stream's token: an int, or a multi-codebook frame's tuple of ints."""
    x = np.ravel(x)
    return int(x[0]) if x.size == 1 else tuple(int(v) for v in x)


def check_streams(reqs, max_new, vocab, all_done=True):
    """Greedy streams of finished requests: terminal, in the vocabulary, and
    of ``max_new`` tokens each when ``all_done``.  Returns {rid: tokens}
    (each token an int, or a tuple over a multi-codebook frame)."""
    streams = {r.rid: [_token(x) for x in r.generated] for r in reqs}
    for r in reqs:
        if all_done and (r.state.name != "DONE" or len(streams[r.rid]) != max_new):
            raise AssertionError(f"request {r.rid} ended {r.state} with "
                                 f"{len(streams[r.rid])}/{max_new} tokens")
        if not r.terminal:
            raise AssertionError(f"request {r.rid} did not reach a terminal state")
        if not all(0 <= v < vocab for x in streams[r.rid] for v in np.ravel(x)):
            raise AssertionError(f"request {r.rid}: token out of range")
    return streams


def serve(cfg, params, prompts, max_new, *, slots=8, max_len=1024, all_done=True,
          timed=False, extras=None, **kw):
    """Serve ``prompts`` (all arriving at once, request ``i`` with
    ``extras[i]`` when given) greedily through the port's engine on the
    card, with a prefill chunk of 256 unless ``kw`` sets one.  Every
    forward that carries a decode row, a mixed tile or a verify tile
    (plain, guarded, horizon or speculative decode, mixed dispatch) must
    launch ``paged_attention`` once per layer, and
    every forward of an int8/sc engine runs ``odin_linear`` on each
    projection; the launch counts are set to 0 just before the run and read
    just after it (:class:`counting`)."""
    from repro_torch.serving import Request, ServingEngine

    kw.setdefault("prefill_chunk", 256)
    eng = ServingEngine(cfg, slots=slots, max_len=max_len, block_size=16, params=params,
                        **kw)
    reqs = [Request(rid=i, prompt=pr, max_new=max_new,
                    extras=None if extras is None else extras[i])
            for i, pr in enumerate(prompts)]
    torch.cuda.reset_peak_memory_stats()
    with counting(eng, timed) as c:
        t = time.perf_counter()
        summary = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    streams = check_streams(reqs, max_new, cfg.vocab, all_done)
    c.check(cfg)
    return dict(summary=summary, streams=streams, launches=c.launches,
                launches_by_q=c.by_q, sc_launches=c.sc_launches, forwards=c.forwards,
                prefill_forwards=c.prefill_forwards, wall=wall,
                peak=torch.cuda.max_memory_allocated(), requests=reqs, times=c.times)


def serve_full_width(cfg, params, prompts, rng):
    """Exact-mode serving at full width: the smoke traffic with mixed
    dispatch on and off, pool pressure at horizon 1 and 4, a decode profile.
    Returns each run's ``paged_attention`` launches, and the mixed run's
    streams and decode tokens/s."""
    def run(prompts, max_new, **kw):
        return serve(cfg, params, prompts, max_new, **kw)

    def compare(base, other, prompts, what):
        compare_streams(params, cfg, prompts, base, other, what)

    a = run(prompts, 64)
    s1 = a["summary"]
    result = {
        "requests": 8, "prompt": 512, "generated": 64, "wall_s": a["wall"],
        "decode_tokens_per_s": s1["decode_tokens_per_s"],
        "ttft_s": s1["ttft_s"], "tpot_s": s1["tpot_s"],
        "mixed_dispatches": s1["mixed"]["dispatches"],
        "decode_dispatches": s1["decode_dispatches"],
        "forwards_through_kernel": a["forwards"], "paged_attn_launches": a["launches"],
        "launches_per_forward": a["launches"] / a["forwards"],
        "peak_memory_gb": a["peak"] / 1e9, "kv_cache_bytes": s1["kv_cache_bytes"],
    }
    log("full-width serving:", json.dumps(result))
    b = run(prompts, 16, mixed=False)
    log(f"mixed=False run: {b['forwards']} decode forwards, {b['launches']} launches, "
        f"{b['wall']:.1f} s")
    compare({rid: s[:16] for rid, s in a["streams"].items()}, b["streams"], prompts,
            "mixed=False vs the mixed run's first 16 tokens")

    # pool pressure: 16 requests sharing a 256-token prefix in a pool of 200
    # blocks (the 8 slots would hold 8 x 38) with a 64-block swap tier, so
    # prefix hits and swap preemptions happen; the tenth request repeats the
    # ninth one's prompt, whose cached last block it must fork (copy on
    # write).  Suffixes start with distinct tokens so no other hit reaches
    # past the shared prefix.  Then the same traffic with horizon-4 decode,
    # held against the horizon-1 run.
    shared = rng.integers(0, cfg.vocab, size=256, dtype=np.int32)
    suffix = rng.integers(0, cfg.vocab, size=(16, 256), dtype=np.int32)
    suffix[:, 0] = rng.permutation(cfg.vocab)[:16]
    suffix[9] = suffix[8]
    pressure = [np.concatenate([shared, sfx]) for sfx in suffix]
    runs = {}
    for h in (1, 4):
        r = runs[h] = run(pressure, 96, n_blocks=200, swap_blocks=64, horizon=h)
        s = r["summary"]
        line = {"horizon": h, "wall_s": r["wall"], "forwards_through_kernel": r["forwards"],
                "paged_attn_launches": r["launches"],
                "decode_steps": s["decode_steps"], "decode_dispatches": s["decode_dispatches"],
                "mixed_dispatches": s["mixed"]["dispatches"],
                "preemptions": s["preemptions"], "prefix": s["prefix"],
                "decode_tokens_per_s": s["decode_tokens_per_s"]}
        log("pool-pressure serving:", json.dumps(line))
        if s["preemptions"]["swap"] <= 0 or s["prefix"]["hit_tokens"] <= 0 \
                or s["prefix"]["cow_forks"] <= 0:
            raise AssertionError(f"horizon {h}: no swap preemption, prefix hit or "
                                 f"copy-on-write fork: {line}")
    if runs[4]["summary"]["decode_dispatches"] >= runs[4]["summary"]["decode_steps"]:
        raise AssertionError("horizon 4: no dispatch ran more than one decode step")
    compare(runs[1]["streams"], runs[4]["streams"], pressure, "horizon 4 vs horizon 1")
    profile_decode(params, cfg, prompts)
    launches = {"serve_exact": a["launches"], "serve_exact_unmixed": b["launches"],
                "serve_pressure_h1": runs[1]["launches"],
                "serve_pressure_h4": runs[4]["launches"]}
    return launches, a["streams"], s1["decode_tokens_per_s"]


# bf16 logits of magnitude 4-8 carry 2^-5 steps; 0.125 is four of them.  The
# mixed tile and the plain decode step run the same math at different batch
# shapes, and eager PyTorch on the card picks its GEMM and reduction
# algorithms per shape, so their bf16 roundings differ.
LOGIT_TIE_TOL = 0.125


def compare_streams(params, cfg, prompts, base, other, what, extras=None):
    """Log how many of two runs' streams are equal and hold every parting to
    a near tie (:func:`check_divergence`).  Returns the count of equal ones."""
    n_equal = sum(base[rid] == other[rid] for rid in base)
    log(f"{what}: {n_equal}/{len(base)} streams equal")
    for rid in base:
        check_divergence(params, cfg, prompts[rid], base[rid], other[rid], rid, what,
                         extras=None if extras is None else extras[rid])
    return n_equal


def check_divergence(params, cfg, prompt, a, b, rid, what="mixed on/off", extras=None):
    """Two greedy streams of one request may part only at a near tie: at the
    first differing step both tokens must be the reference forward's top two,
    with logits within LOGIT_TIE_TOL.  Each such step is reported.  The
    reference forward routes MoE blocks drop-free, as serving does; a
    multi-codebook frame is held codebook by codebook (every codebook that
    differs at that step must be a near tie of its own head), and a vision
    request's forward takes its extras, its generated tail at (t, t, t)."""
    from repro_torch.models import lm
    t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if t is None:
        return
    dev = params["embed"].device
    prompt = np.asarray(prompt, np.int32)
    K = prompt.shape[0] if prompt.ndim == 2 else 1
    gen = np.asarray(a[:t], np.int32).reshape(t, K).T               # [K, t]
    ctx = np.concatenate([prompt, gen if prompt.ndim == 2 else gen[0]], axis=-1)
    kw = {}
    if extras is not None:
        pos3d = extras["pos3d"]
        tail = np.repeat(np.arange(len(pos3d), ctx.shape[-1], dtype=np.int32)[:, None], 3, 1)
        kw = {"patch_embeds": torch.as_tensor(extras["patch_embeds"], device=dev)[None],
              "pos3d": torch.as_tensor(np.concatenate([pos3d, tail]), device=dev)[None]}
    with torch.no_grad():
        logits = lm.forward(params, torch.as_tensor(ctx, device=dev)[None], cfg,
                            moe_no_drop=True, **kw)[0][0, -1].float()
    logits = logits.reshape(-1, logits.shape[-1])                   # [K, V]
    xa, xb = np.ravel(a[t]), np.ravel(b[t])
    for k in np.flatnonzero(xa != xb):
        top = torch.topk(logits[k], 2)
        gap = abs(logits[k, xa[k]].item() - logits[k, xb[k]].item())
        report = {"streams": what, "rid": rid, "step": t, "token_a": int(xa[k]),
                  "token_b": int(xb[k]), "reference_top2": top.indices.tolist(),
                  "reference_top2_gap": (top.values[0] - top.values[1]).item(),
                  "gap_between_tokens": gap, "tol": LOGIT_TIE_TOL}
        if len(xa) > 1:
            report["codebook"] = int(k)
        log("stream divergence at a near tie:", json.dumps(report))
        if set(top.indices.tolist()) != {int(xa[k]), int(xb[k])} or gap > LOGIT_TIE_TOL:
            raise AssertionError(f"request {rid}: {what} streams part at step {t} "
                                 f"without a near tie: {report}")


def profile_decode(params, cfg, prompts, *, block=4, max_new=32, max_len=1024,
                   label="decode profile (8 slots, 4 steps each block)", op_shares=None):
    """Plain decode steps of the full-width engine, one slot a prompt: after
    ``block`` warm-up steps, ``block`` timed without the profiler, ``block``
    under it and ``block`` more without it.  Reports device time by kernel,
    device operations per step, and the busy share of each wall time.
    Kernel durations come from the profiled steps; the unprofiled share
    divides them by the mean wall time of the unprofiled steps around them,
    same engine and batch.  ``op_shares`` maps a label to a predicate on the
    profiler's operator rows (grouped by input shape): the device time of
    the kernels those operators launched is reported a step and as a share
    (a ``record_function`` range's row counts the kernels of every operator
    inside it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import Request, ServingEngine
    slots = len(prompts)
    eng = ServingEngine(cfg, slots=slots, max_len=max_len, block_size=16,
                        prefill_chunk=256, params=params, mixed=False)
    for i in range(slots):
        eng.submit(Request(rid=i, prompt=prompts[i], max_new=max_new))
    while any(r.n_generated < 2 for r in eng.sched.running.values()) \
            or len(eng.sched.running) < slots:
        eng.step()

    def steps():
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(block):
            eng.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / block

    steps()
    before = steps()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=bool(op_shares)) as prof:
        wall_prof = steps()
    after = steps()
    wall_plain = (before + after) / 2
    if len(eng.sched.running) != slots:
        raise AssertionError("decode profile: a request finished inside the timed steps")
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side events only: an operator's own row repeats its kernels' time
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = sum(dev_us(e) for e in kernels) / (block * 1e6)
    if busy <= 0:
        raise AssertionError("decode profile: the profiler recorded no device time")
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    name = f"profile_decode_{cfg.name}_{cfg.odin_mode}.txt"
    with open(os.path.join(HERE, "build", name), "w") as fh:
        fh.write(events.table(sort_by="self_cuda_time_total", row_limit=40))
    report = {
        "wall_ms_per_step_unprofiled": wall_plain * 1e3,
        "wall_ms_per_step_unprofiled_runs": [before * 1e3, after * 1e3],
        "wall_ms_per_step_profiled": wall_prof * 1e3,
        "device_busy_ms_per_step": busy * 1e3,
        "device_busy_share_unprofiled": busy / wall_plain,
        "device_busy_share_profiled": busy / wall_prof,
        "device_ops_per_step": sum(e.count for e in kernels) / block,
        "sc_mac_device_share": sum(dev_us(e) for e in kernels if "sc_mac" in e.key)
        / (busy * block * 1e6),
        "paged_attn_ms_per_step": sum(dev_us(e) for e in kernels if "paged_attn" in e.key)
        / (block * 1e3),
        "paged_attn_device_share": sum(dev_us(e) for e in kernels if "paged_attn" in e.key)
        / (busy * block * 1e6),
        "top_device_ms_per_step": {e.key[:60]: dev_us(e) / (block * 1e3) for e in top}}
    if op_shares:
        by_shape = prof.key_averages(group_by_input_shape=True)

        def op_dev_us(e):       # an operator row: the device time of its kernels
            return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)

        for what, pick in op_shares.items():
            rows = [e for e in by_shape if e.device_type == DeviceType.CPU and pick(e)]
            us = sum(op_dev_us(e) for e in rows)
            report[f"{what}_ms_per_step"] = us / (block * 1e3)
            report[f"{what}_device_share"] = us / (busy * block * 1e6)
            report[f"{what}_calls_per_step"] = sum(e.count for e in rows) / block
    log(f"{label}:", json.dumps(report))
    return report


# ---------------------------------------------------------------------------
# phases 4b-4c: speculative decoding and the front door
# ---------------------------------------------------------------------------

SPEC_K, SPEC_H = 4, 4            # draft length and horizon of the spec phase


def serve_spec(cfg, params, prompts, exact_streams, exact_tps):
    """n-gram self-speculative decoding at full width (K = 4 drafts a step,
    up to 4 steps a dispatch): every inner step is one forward over a
    5-token verify tile, which reaches ``paged_attention`` at Q = 5.  The
    serving phase's 8 prompts of 512 tokens with 64 greedy tokens, whose
    streams must equal the spec-off run's (``exact_streams``, mixed
    dispatch at horizon 1, ``exact_tps`` decode tokens/s) except at reported
    near ties; then 8 prompts of
    512 tokens tiled from a random 8-token pattern each (the ``repetitive``
    scenario's traffic at the serving phase's lengths), 64 tokens, served
    with speculation off and on at horizon 4 and held against each other.
    Returns each run's ``paged_attention`` launches, and its launches by
    query length."""
    rng = np.random.default_rng(17)
    on = serve(cfg, params, prompts, 64, spec_ngram=SPEC_K, horizon=SPEC_H)
    pats = rng.integers(0, cfg.vocab, size=(len(prompts), 8), dtype=np.int32)
    rep = [np.tile(p, 64) for p in pats]
    rep_off = serve(cfg, params, rep, 64, horizon=SPEC_H)
    rep_on = serve(cfg, params, rep, 64, spec_ngram=SPEC_K, horizon=SPEC_H)
    lines = {}
    for what, r, base, prm in (("serving traffic", on, exact_streams, prompts),
                               ("repetitive traffic", rep_on, rep_off["streams"], rep)):
        if r["launches_by_q"].get(SPEC_K + 1, 0) <= 0:
            raise AssertionError(f"spec run on {what}: no paged_attention launch at "
                                 f"Q = {SPEC_K + 1}: {r['launches_by_q']}")
        n_equal = compare_streams(params, cfg, prm, base, r["streams"],
                                  f"spec off/on, {what}")
        s = r["summary"]
        if s["speculation"]["drafted"] <= 0:
            raise AssertionError(f"spec run on {what} drafted nothing: {s['speculation']}")
        lines[what] = {
            "traffic": what, "requests": len(prm), "prompt": 512, "generated": 64,
            "spec_k": SPEC_K, "horizon": SPEC_H, "wall_s": r["wall"],
            "streams_equal_to_spec_off": n_equal, "speculation": s["speculation"],
            "tokens_per_dispatch": s["tokens_per_dispatch"],
            "decode_dispatches": s["decode_dispatches"], "decode_steps": s["decode_steps"],
            "decode_tokens_per_s": s["decode_tokens_per_s"],
            "forwards_through_kernel": r["forwards"], "paged_attn_launches": r["launches"],
            "paged_attn_launches_by_q": r["launches_by_q"],
            "peak_memory_gb": r["peak"] / 1e9}
    lines["serving traffic"]["spec_off_h1_decode_tokens_per_s"] = exact_tps
    off = rep_off["summary"]
    lines["repetitive traffic"].update(
        spec_off_decode_tokens_per_s=off["decode_tokens_per_s"],
        spec_off_tokens_per_dispatch=off["tokens_per_dispatch"],
        spec_off_decode_dispatches=off["decode_dispatches"],
        spec_off_wall_s=rep_off["wall"], spec_off_paged_attn_launches=rep_off["launches"])
    for line in lines.values():
        log("speculative serving:", json.dumps(line))
    launches = {"serve_spec": on["launches"], "serve_spec_repetitive": rep_on["launches"],
                "serve_repetitive_h4": rep_off["launches"]}
    by_q = {}
    for r in (on, rep_on):
        for q, n in r["launches_by_q"].items():
            by_q[q] = by_q.get(q, 0) + n
    return launches, by_q


# ---------------------------------------------------------------------------
# phase 7: Mixture-of-Experts at full width
# ---------------------------------------------------------------------------

MOE_ARCH, MOE_LAYERS = "qwen3-moe-235b-a22b", 8


def load_qwen3():
    """qwen3-moe-235b-a22b at every published width (d_model 4096, 64 query
    heads over 4 KV heads of 128, 128 experts, top-8, expert d_ff 1536, vocab
    151,936) over 8 of its 94 layers, random bf16 weights (the router
    float32) from a seeded generator on the card, and eight 512-token prompts."""
    import dataclasses

    from repro_torch.models import lm, registry
    from repro_torch.nn.module import count_params, materialize

    full = registry.get_config(MOE_ARCH)
    cfg = full.with_overrides(blocks=tuple(dataclasses.replace(b, n_layers=MOE_LAYERS)
                                           for b in full.blocks))
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = materialize(lm.param_spec(cfg), gen, "cuda")
    torch.cuda.synchronize()
    n = count_params(lm.param_spec(cfg))
    log(f"{MOE_ARCH}: {n / 1e9:.3f} B params ({2 * n / 1e9:.1f} GB in bf16) of the "
        f"published {count_params(lm.param_spec(full)) / 1e9:.2f} B, materialized on the "
        f"card in {time.perf_counter() - t0:.1f} s; reduced: "
        + json.dumps({"n_layers": f"{full.n_layers} -> {cfg.n_layers}"}))
    rng = np.random.default_rng(0)
    prompts = list(rng.integers(0, cfg.vocab, size=(8, 512), dtype=np.int32))
    return cfg, params, prompts


def _is_expert_bmm(cfg):
    """Profiler row of an expert product: ``aten::bmm`` over n_experts batches."""
    E = next(b.moe.n_experts for b in cfg.blocks if b.moe is not None)
    return lambda e: (e.key == "aten::bmm" and bool(e.input_shapes)
                      and bool(e.input_shapes[0]) and e.input_shapes[0][0] == E)


def serve_moe(cfg, params, prompts):
    """qwen3-moe-235b-a22b served through the port's engine on the card: the
    serving phase's 8 prompts of 512 tokens, 32 greedy tokens with the
    engine's defaults (mixed dispatch, prefix sharing); 16 with mixed
    dispatch off, whose streams are held against the first run's (a parting
    only at a reported near tie); n-gram speculation (K = 4, horizon 4) on
    prompts tiled from an 8-token pattern against a spec-off run at horizon
    4, held the same way; then a decode profile with the expert products'
    and ``paged_attn``'s shares.  Every forward that carries a decode row, a
    mixed tile or a verify tile launches ``paged_attention`` once per layer
    (:class:`counting`).  Returns each run's launches and the spec runs'
    launches by query length."""
    a = serve(cfg, params, prompts, 32)
    s1 = a["summary"]
    line = {"arch": MOE_ARCH, "layers": cfg.n_layers, "requests": 8, "prompt": 512,
            "generated": 32, "wall_s": a["wall"],
            "decode_tokens_per_s": s1["decode_tokens_per_s"], "ttft_s": s1["ttft_s"],
            "tpot_s": s1["tpot_s"], "mixed_dispatches": s1["mixed"]["dispatches"],
            "decode_dispatches": s1["decode_dispatches"],
            "forwards_through_kernel": a["forwards"], "paged_attn_launches": a["launches"],
            "launches_per_forward": a["launches"] / a["forwards"],
            "peak_memory_gb": a["peak"] / 1e9, "kv_cache_bytes": s1["kv_cache_bytes"]}
    log("moe serving:", json.dumps(line))
    b = serve(cfg, params, prompts, 16, mixed=False)
    log(f"moe mixed=False run: {b['forwards']} decode forwards, {b['launches']} launches, "
        f"{b['wall']:.1f} s")
    compare_streams(params, cfg, prompts, {rid: st[:16] for rid, st in a["streams"].items()},
                    b["streams"], "moe mixed=False vs the mixed run's first 16 tokens")

    rng = np.random.default_rng(17)
    pats = rng.integers(0, cfg.vocab, size=(len(prompts), 8), dtype=np.int32)
    rep = [np.tile(p, 64) for p in pats]
    off = serve(cfg, params, rep, 32, horizon=SPEC_H)
    on = serve(cfg, params, rep, 32, spec_ngram=SPEC_K, horizon=SPEC_H)
    if on["launches_by_q"].get(SPEC_K + 1, 0) <= 0:
        raise AssertionError(f"moe spec run: no paged_attention launch at Q = {SPEC_K + 1}: "
                             f"{on['launches_by_q']}")
    n_equal = compare_streams(params, cfg, rep, off["streams"], on["streams"],
                              "moe spec off/on, repetitive traffic")
    s_on, s_off = on["summary"], off["summary"]
    if s_on["speculation"]["drafted"] <= 0:
        raise AssertionError(f"moe spec run drafted nothing: {s_on['speculation']}")
    log("moe speculative serving:", json.dumps({
        "traffic": "repetitive", "requests": len(rep), "prompt": 512, "generated": 32,
        "spec_k": SPEC_K, "horizon": SPEC_H, "streams_equal_to_spec_off": n_equal,
        "speculation": s_on["speculation"], "tokens_per_dispatch": s_on["tokens_per_dispatch"],
        "decode_tokens_per_s": s_on["decode_tokens_per_s"], "wall_s": on["wall"],
        "paged_attn_launches": on["launches"], "paged_attn_launches_by_q": on["launches_by_q"],
        "spec_off_tokens_per_dispatch": s_off["tokens_per_dispatch"],
        "spec_off_decode_tokens_per_s": s_off["decode_tokens_per_s"],
        "spec_off_wall_s": off["wall"], "spec_off_paged_attn_launches": off["launches"],
        "peak_memory_gb": max(on["peak"], off["peak"]) / 1e9}))
    profile_decode(params, cfg, prompts, label="moe decode profile (8 slots, 4 steps each "
                   "block)", op_shares={"expert_bmm": _is_expert_bmm(cfg)})
    launches = {"serve_moe": a["launches"], "serve_moe_unmixed": b["launches"],
                "serve_moe_repetitive_h4": off["launches"], "serve_moe_spec": on["launches"]}
    return launches, on["launches_by_q"]


# ---------------------------------------------------------------------------
# phase 10: multi-head latent attention (deepseek-v3) at full width
# ---------------------------------------------------------------------------

MLA_ARCH, MLA_MOE_LAYERS = "deepseek-v3-671b", 2


def mla_card_vs_cpu():
    """deepseek-v3-671b at every published width over 1 dense and 1 MoE
    layer (no MTP subtree: serving never runs it), float32 weights (55.8 GB)
    from a seeded generator on the card and their copy on the host: the
    logits of a 24-token prefill of 2 slots and 3 decode steps on serving
    caches (per-slot ``pos``, float32 latents, drop-free routing over all
    256 experts) are equal on the card and on the CPU (the plain path that
    the CPU tests hold against the JAX package), within atol/rtol 1e-4 (the
    CPU tests' bound: float32 sums in another order).  The full-width
    serving runs hold the card against itself; this is their witness for
    the MoE half.  The init's fan-in spans the stacked expert axis (the
    reference's rule), which leaves a random routed expert's output near
    1e-4 of the residual, below the bound; so the check scales the routed
    experts' weights by sqrt(256), to each expert's own fan-in, and then
    must see them: with their ``w_down`` zeroed on the card, most logits
    move past the bound.  Returns the card run's ``paged_attention``
    launches (0: the latent cache is dense)."""
    import dataclasses

    from repro_torch.kernels.paged_attn import paged_attention
    from repro_torch.launch.steps import init_serving_caches
    from repro_torch.models import lm, registry
    from repro_torch.nn.module import count_params, materialize
    from repro_torch.tree import tree_map

    full = registry.get_config(MLA_ARCH)
    dense, moe = full.blocks
    cfg = full.with_overrides(kv_dtype="float32", mtp=False, blocks=(
        dataclasses.replace(dense, n_layers=1), dataclasses.replace(moe, n_layers=1)))
    spec = tree_map(lambda s: dataclasses.replace(s, dtype=torch.float32),
                    lm.param_spec(cfg))
    t0 = time.perf_counter()
    card = materialize(spec, torch.Generator(device="cuda").manual_seed(0), "cuda")
    experts = card["segments"][1]["moe"]
    for name in ("w_gate", "w_up", "w_down"):
        experts[name].mul_(math.sqrt(moe.moe.n_experts))
    host = tree_map(lambda t: t.cpu(), card)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(7)
    B, S, steps = 2, 24, 3
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, size=(B, S), dtype=np.int32))
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(steps, B, 1), dtype=np.int32))

    def logits(p, dev):
        caches = init_serving_caches(cfg, B, 64, device=dev)
        out, caches, _ = lm.forward(p, prompt.to(dev), cfg, caches=caches, moe_no_drop=True)
        outs = [out]
        for i in range(steps):
            start = torch.full((B, 1), S + i, dtype=torch.int32, device=dev)
            out, caches, _ = lm.forward(p, toks[i].to(dev), cfg, caches=caches,
                                        start_pos=start, moe_no_drop=True)
            outs.append(out)
        return torch.cat(outs, dim=1).cpu()              # [B, S + steps, V]

    paged_attention.launches = 0
    t = time.perf_counter()
    on_card = logits(card, "cuda")
    card_s = time.perf_counter() - t
    launches = paged_attention.launches
    t = time.perf_counter()
    on_cpu = logits(host, "cpu")
    cpu_s = time.perf_counter() - t
    del host
    if launches:
        raise AssertionError(f"mla card check: paged_attention launched {launches}x")
    if not bool(torch.isfinite(on_card).all()):
        raise AssertionError("mla card check: non-finite logits on the card")
    err = (on_card - on_cpu).abs()
    bound = 1e-4 + 1e-4 * on_cpu.abs()
    if not bool((err <= bound).all()):
        raise AssertionError(f"mla card check: card logits off the CPU's by "
                             f"{err.max():.3e}")
    experts["w_down"].zero_()
    moved = (logits(card, "cuda") - on_card).abs()
    seen = (moved > bound).float().mean().item()
    if seen < 0.5:
        raise AssertionError(f"mla card check: zeroing the routed experts moves "
                             f"{seen:.1%} of the logits past the bound; the check "
                             f"cannot see them")
    log("mla card vs cpu:", json.dumps({
        "arch": MLA_ARCH, "layers": "1 dense + 1 MoE of 61", "dtype": "float32",
        "params_b": count_params(spec) / 1e9, "slots": B, "prefill": S, "decode_steps": steps,
        "logits_max_abs_err": err.max().item(), "logits_max_abs": on_cpu.abs().max().item(),
        "routed_experts_zeroed_max_move": moved.max().item(),
        "routed_experts_zeroed_share_past_bound": seen,
        "setup_s": setup_s, "card_s": card_s, "cpu_s": cpu_s,
        "paged_attn_launches": launches}))
    return launches


def load_deepseek():
    """deepseek-v3-671b at every published width (d_model 7168, 128 heads,
    q/kv ranks 1536/512, qk 128 + 64, v 128, 256 experts top-8 of d_ff 2048
    + 1 shared, dense d_ff 18,432, vocab 129,280) over its 3 dense layers and
    2 of its 58 MoE layers, with the MTP subtree (materialised, unused by
    serving), random bf16 weights (the norms, router and route bias float32)
    from a seeded generator on the card, and eight 512-token prompts."""
    import dataclasses

    from repro_torch.models import lm, registry
    from repro_torch.nn.module import count_params, materialize

    full = registry.get_config(MLA_ARCH)
    dense, moe = full.blocks
    cfg = full.with_overrides(blocks=(dense, dataclasses.replace(moe, n_layers=MLA_MOE_LAYERS)))
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = materialize(lm.param_spec(cfg), gen, "cuda")
    torch.cuda.synchronize()
    n = count_params(lm.param_spec(cfg))
    a = dense.attn
    latent = (a.kv_lora_rank + a.qk_rope_dim) * 2
    gqa = a.n_heads * (a.qk_nope_dim + a.qk_rope_dim + a.v_head_dim) * 2
    log(f"{MLA_ARCH}: {n / 1e9:.3f} B params ({2 * n / 1e9:.1f} GB in bf16) of the "
        f"published {count_params(lm.param_spec(full)) / 1e9:.2f} B, materialized on the "
        f"card in {time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 1e9:.1f}"
        f" GB allocated; reduced: "
        + json.dumps({"n_layers": f"{full.n_layers} -> {cfg.n_layers}"}))
    log(f"{MLA_ARCH} cache a token a layer: latent c_kv + k_rope {latent} bytes (bf16) "
        f"against {gqa} bytes for K and V of {a.n_heads} heads ({gqa / latent:.1f}x)")
    rng = np.random.default_rng(0)
    prompts = list(rng.integers(0, cfg.vocab, size=(8, 512), dtype=np.int32))
    return cfg, params, prompts


@contextlib.contextmanager
def moe_drops():
    """Counts the MoE dispatch's assignments and the ones it drops (capped
    capacity) while it is entered."""
    from repro_torch.nn import moe
    tally = {"assignments": 0, "dropped": 0}

    def wrap(fn):
        def counted(expert_ids, *a, **k):
            slot, keep = fn(expert_ids, *a, **k)
            tally["assignments"] += keep.numel()
            tally["dropped"] += int((~keep).sum())
            return slot, keep
        return counted
    with patched(moe, "dispatch_indices", wrap):
        yield tally


def serve_mla(cfg, params, prompts):
    """deepseek-v3-671b served through the port's engine on the card over its
    dense latent cache (``c_kv``/``k_rope`` per slot, no pool: mixed dispatch
    and prefix sharing off by themselves, no ``paged_attention`` launch on
    any run, :class:`counting`): the serving phase's 8 prompts of 512
    tokens, 32 greedy tokens with the engine's defaults; a swap-pressure run
    at horizon 4 (a pool of 165 blocks, which admits 5 prompts of 33 blocks
    and then cannot grow them, with a 136-block swap tier, so the latent rows
    ride the swap ticket); n-gram speculation (K = 4, horizon 4) on prompts
    tiled from an 8-token pattern against a spec-off run at horizon 4; and
    the static loop (``serve_static``, whose one-shot prefill routes the MoE
    with capped capacity, as the reference's does; its drops are counted).
    Each run's streams are held against its base run, a parting accepted
    only at a reported near tie.  Then a decode profile with the shares of
    the latent decompression + ``sdpa`` and of the expert products.
    Returns each run's ``paged_attention`` launches (all 0)."""
    from repro_torch.kernels.paged_attn import paged_attention
    from repro_torch.launch.serve import _batch_requests, serve_static
    from repro_torch.nn import attention

    a = serve(cfg, params, prompts, 32)
    s1 = a["summary"]
    if a["launches"] or s1["mixed"]["dispatches"] or s1["prefix"]["hit_tokens"]:
        raise AssertionError(f"mla serving: kernel launches, mixed dispatches or prefix "
                             f"hits on a dense latent cache: {a['launches']}, {s1['mixed']}")
    log("mla serving:", json.dumps({
        "arch": MLA_ARCH, "layers": cfg.n_layers, "requests": len(prompts), "prompt": 512,
        "generated": 32, "wall_s": a["wall"],
        "decode_tokens_per_s": s1["decode_tokens_per_s"], "ttft_s": s1["ttft_s"],
        "tpot_s": s1["tpot_s"], "prefill_time_s": s1["prefill_time_s"],
        "decode_dispatches": s1["decode_dispatches"], "decode_steps": s1["decode_steps"],
        "forwards": a["forwards"], "paged_attn_launches": a["launches"],
        "peak_memory_gb": a["peak"] / 1e9, "kv_cache_bytes": s1["kv_cache_bytes"]}))
    swap = serve(cfg, params, prompts, 32, n_blocks=165, swap_blocks=136, horizon=SPEC_H)
    s = swap["summary"]
    if s["preemptions"]["swap"] <= 0:
        raise AssertionError(f"mla swap run: no swap preemption {s['preemptions']}")
    if s["decode_dispatches"] >= s["decode_steps"]:
        raise AssertionError("mla swap run: no dispatch ran more than one decode step")
    n_equal = compare_streams(params, cfg, prompts, a["streams"], swap["streams"],
                              "mla swap pressure h4 vs the default run")
    log("mla serving (swap pressure, horizon 4):", json.dumps({
        "wall_s": swap["wall"], "streams_equal_to_default": n_equal,
        "preemptions": s["preemptions"], "decode_dispatches": s["decode_dispatches"],
        "decode_steps": s["decode_steps"], "decode_tokens_per_s": s["decode_tokens_per_s"],
        "ttft_s": s["ttft_s"], "paged_attn_launches": swap["launches"],
        "peak_memory_gb": swap["peak"] / 1e9}))

    rng = np.random.default_rng(17)
    pats = rng.integers(0, cfg.vocab, size=(len(prompts), 8), dtype=np.int32)
    rep = [np.tile(p, 64) for p in pats]
    off = serve(cfg, params, rep, 32, horizon=SPEC_H)
    on = serve(cfg, params, rep, 32, spec_ngram=SPEC_K, horizon=SPEC_H)
    n_equal = compare_streams(params, cfg, rep, off["streams"], on["streams"],
                              "mla spec off/on, repetitive traffic")
    s_on, s_off = on["summary"], off["summary"]
    if s_on["speculation"]["drafted"] <= 0:
        raise AssertionError(f"mla spec run drafted nothing: {s_on['speculation']}")
    log("mla speculative serving:", json.dumps({
        "traffic": "repetitive", "requests": len(rep), "prompt": 512, "generated": 32,
        "spec_k": SPEC_K, "horizon": SPEC_H, "streams_equal_to_spec_off": n_equal,
        "speculation": s_on["speculation"], "tokens_per_dispatch": s_on["tokens_per_dispatch"],
        "decode_tokens_per_s": s_on["decode_tokens_per_s"], "wall_s": on["wall"],
        "spec_off_tokens_per_dispatch": s_off["tokens_per_dispatch"],
        "spec_off_decode_tokens_per_s": s_off["decode_tokens_per_s"],
        "spec_off_wall_s": off["wall"],
        "paged_attn_launches": on["launches"] + off["launches"],
        "peak_memory_gb": max(on["peak"], off["peak"]) / 1e9}))

    static_prompts = [q.prompt for q in _batch_requests(cfg, len(prompts), 512, 32, 0)]
    if not all(np.array_equal(x, y) for x, y in zip(static_prompts, prompts)):
        raise AssertionError("serve_static's prompts are not the serving phase's")
    paged_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with moe_drops() as drops:
        generated, static_tps = serve_static(cfg, batch=len(prompts), prompt_len=512,
                                             gen=32, seed=0, params=params, verbose=False)
    static_wall = time.perf_counter() - t
    static_launches = paged_attention.launches
    if static_launches:
        raise AssertionError(f"the static loop launched paged_attention {static_launches}x")
    if not ((generated >= 0) & (generated < cfg.vocab)).all():
        raise AssertionError("serve_static: token out of range")
    static = {i: [int(x) for x in row] for i, row in enumerate(generated)}
    n_static = compare_streams(params, cfg, prompts, a["streams"], static,
                               "mla serve_static vs the engine's default run")
    log("mla static loop:", json.dumps({
        "wall_s": static_wall, "decode_tokens_per_s": static_tps,
        "streams_equal_to_engine": n_static,
        "moe_assignments": drops["assignments"],
        "moe_dropped_at_capped_prefill": drops["dropped"],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "paged_attn_launches": static_launches}))
    with ranged(attention, "mla_decompress_attend"):
        profile_decode(params, cfg, prompts, label="mla decode profile (8 slots, 4 steps "
                       "each block)", op_shares={
                           "mla_decompress_attend": lambda e: e.key == "mla_decompress_attend",
                           "expert_bmm": _is_expert_bmm(cfg)})
    return {"serve_mla": a["launches"], "serve_mla_swap_h4": swap["launches"],
            "serve_mla_repetitive_h4": off["launches"], "serve_mla_spec": on["launches"],
            "serve_mla_static": static_launches}


def _free_port() -> int:
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def _post_generate(port, body, timeout=600):
    """One ``POST /generate`` on 127.0.0.1; returns (status line, the SSE
    events' JSON payloads)."""
    import asyncio
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = json.dumps(body).encode()
    writer.write(b"POST /generate HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                 + f"Content-Length: {len(data)}\r\n\r\n".encode() + data)
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(), timeout)
    writer.close()
    await writer.wait_closed()
    head, _, rest = raw.decode().partition("\r\n\r\n")
    return head.splitlines()[0], [json.loads(x[len("data: "):]) for x in rest.split("\n")
                                  if x.startswith("data: ")]


def frontdoor(cfg, params, prompts):
    """The asyncio front door over the port's engine at full width, mixed
    dispatch off so that every dispatch has one shape whatever the arrival
    order.  The serving phase's 8 prompts of 512 tokens, 32 greedy tokens
    each, submitted in one event loop; a ninth submission overflows the
    queue (``Overloaded`` with a retry-after); one consumer disconnects
    after 8 tokens (its request cancelled, its blocks freed).  Every other
    stream must equal ``engine.run``'s on the same requests, and the
    cancelled one a prefix of its own, except at reported near ties.  Then
    one ``POST /generate`` over ``run_server`` on 127.0.0.1 and an ephemeral
    port: its SSE token events must equal the in-process stream of the same
    prompt.  Returns the ``paged_attention`` launches of the reference run
    and of the front door's."""
    import asyncio

    from repro_torch.serving import (FrontDoor, Overloaded, Request, RequestState,
                                     ServingEngine, run_server)
    max_new, cancel_rid, cancel_after = 32, 3, 8

    def engine():
        return ServingEngine(cfg, slots=len(prompts), max_len=1024, block_size=16,
                             prefill_chunk=256, params=params, mixed=False)

    def requests():
        return [Request(rid=i, prompt=p, max_new=max_new) for i, p in enumerate(prompts)]

    ref_eng, ref_reqs = engine(), requests()
    with counting(ref_eng) as c0:
        ref_eng.run(ref_reqs)
    c0.check(cfg)
    ref = check_streams(ref_reqs, max_new, cfg.vocab)

    eng, reqs = engine(), requests()
    extra = Request(rid=len(prompts), prompt=prompts[0], max_new=max_new)

    async def burst():
        fd = FrontDoor(eng, max_queue=len(reqs))
        await fd.start()
        streams = [fd.submit(r) for r in reqs]
        overflow = None
        try:
            fd.submit(extra)
        except Overloaded as e:
            overflow = e

        async def consume(r, stream):
            toks, done = [], None
            async for ev in stream:
                if ev.kind == "token":
                    toks.append(ev.token[0])
                    if r.rid == cancel_rid and len(toks) >= cancel_after:
                        break
                elif ev.kind == "done":
                    done = ev
            await stream.aclose()          # the disconnect: cancels the request
            return toks, done

        outs = await asyncio.gather(*[consume(r, st) for r, st in zip(reqs, streams)])
        summ = fd.summary()
        await fd.aclose()
        return outs, overflow, summ

    async def http():
        fd = FrontDoor(eng, max_queue=len(reqs))
        ready, port = asyncio.Event(), _free_port()
        server = asyncio.ensure_future(run_server(fd, "127.0.0.1", port, vocab=cfg.vocab,
                                                  install_signals=False, ready=ready))
        await asyncio.wait_for(ready.wait(), 60)
        try:
            return await _post_generate(port, {"prompt": prompts[0].tolist(),
                                               "max_new": max_new})
        finally:
            server.cancel()
            try:
                await server
            except asyncio.CancelledError:
                pass

    with counting(eng) as c:
        t = time.perf_counter()
        outs, overflow, summ = asyncio.run(burst())
        wall = time.perf_counter() - t
        t = time.perf_counter()
        status, events = asyncio.run(http())
        http_wall = time.perf_counter() - t
    c.check(cfg)
    if overflow is None or overflow.retry_after is None or overflow.retry_after < 0:
        raise AssertionError(f"front door: the ninth submission was not rejected with "
                             f"a retry-after ({overflow!r})")
    if summ["rejected_queue"] != 1 or summ["disconnect_cancels"] != 1 \
            or summ["accepted"] != len(reqs) or summ["live_streams"] != 0:
        raise AssertionError(f"front door summary {summ}")
    got = {}
    for r, (toks, done) in zip(reqs, outs):
        if r.rid == cancel_rid:
            if r.state is not RequestState.CANCELLED or r.finish_reason != "disconnect" \
                    or len(toks) != cancel_after:
                raise AssertionError(f"rid {r.rid}: {r.state} {r.finish_reason} after "
                                     f"{len(toks)} tokens")
        elif (done is None or done.state != "done" or done.n_tokens != len(toks)
              or len(toks) != max_new):
            raise AssertionError(f"rid {r.rid}: stream ended {done} with {len(toks)} tokens")
        got[r.rid] = toks
    n_equal = compare_streams(params, cfg, prompts,
                              {rid: ref[rid][:len(s)] for rid, s in got.items()}, got,
                              "engine.run vs front door")
    cache = eng.sched.prefix_cache
    held = len(cache.held_blocks()) if cache is not None else 0
    if eng.pool.used_blocks != held or len(eng.sched.free_slots) != eng.slots:
        raise AssertionError(f"front door leaked: {eng.pool.used_blocks} blocks used "
                             f"({held} held by the prefix cache), "
                             f"{len(eng.sched.free_slots)}/{eng.slots} slots free")
    sse = [e["token"][0] for e in events if e["kind"] == "token"]
    if status != "HTTP/1.1 200 OK" or events[-1]["kind"] != "done" \
            or events[-1]["state"] != "done" or len(sse) != max_new:
        raise AssertionError(f"POST /generate: {status}, last event {events[-1:]}, "
                             f"{len(sse)} tokens")
    check_divergence(params, cfg, prompts[0], got[0], sse, 0, "in-process vs SSE")
    line = {"requests": len(reqs), "prompt": 512, "generated": max_new, "mixed": False,
            "wall_s": wall, "streams_equal_to_engine_run": n_equal,
            "cancelled_rid": cancel_rid, "cancelled_after_tokens": cancel_after,
            "overflow_retry_after_s": overflow.retry_after, "front_door": summ,
            "sse_status": status, "sse_events": len(events), "sse_wall_s": http_wall,
            "sse_equals_in_process": sse == got[0],
            "forwards_through_kernel": c.forwards, "paged_attn_launches": c.launches,
            "engine_run_paged_attn_launches": c0.launches}
    log("front door:", json.dumps(line))
    return {"frontdoor_engine_run": c0.launches, "frontdoor": c.launches}


# ---------------------------------------------------------------------------
# phase 5: the ODIN compute kernels vs their plain versions
# ---------------------------------------------------------------------------

def check_sc_mac():
    """The stochastic MAC kernel against its plain version, bit for bit on
    the int32 popcounts, at every shape and tiling of the CNN1 path
    (evaluation batch 64: conv0, fc2 and fc3 as a full tree and at blocks 32
    and 8), CNN2's conv0 and the kernel bench.  Bound: the 32-bit operations
    the function needs (one B→S gather per operand element and stream word,
    an AND per real leaf word, a mux per tree node, a popcount per tile
    word) against the INT32 lane rate, and the bytes (uint8 operands, int32
    popcounts, the LUTs) against HBM."""
    from repro_torch.kernels.sc_mac import tile_k

    conv0 = 64 * 28 * 28
    cases = [  # name, M, K, N, block_k (0: one full tree over K̂)
        ("bench_16x64x16_tree", 16, 64, 16, 0),
        ("cnn1_conv0_b64_tree", conv0, 25, 4, 0),
        ("cnn1_conv0_b64_hybrid8", conv0, 25, 4, 8),
        ("cnn1_fc2_b64_hybrid32", 64, 784, 70, 32),
        ("cnn1_fc2_b64_hybrid8", 64, 784, 70, 8),
        ("cnn1_fc2_b64_full_tree", 64, 784, 70, 0),
        ("cnn1_fc3_b64_hybrid32", 64, 70, 10, 32),
        ("cnn1_fc3_b64_hybrid8", 64, 70, 10, 8),
        ("cnn1_fc3_b64_full_tree", 64, 70, 10, 0),
        ("cnn2_conv0_b64_hybrid32", 64 * 22 * 22, 49, 10, 32),
        ("full_tree_past_2048", 64, 3000, 70, 0),
        ("structural_512x4096x512_hybrid256", 512, 4096, 512, 256),
    ]
    g = torch.Generator(device="cuda").manual_seed(12)
    lines = {}
    for name, M, K, N, block_k in cases:
        a = torch.randint(0, 256, (M, K), generator=g, device="cuda", dtype=torch.int32).to(torch.uint8)
        w = torch.randint(0, 256, (K, N), generator=g, device="cuda", dtype=torch.int32).to(torch.uint8)
        lines[name] = time_sc_mac(name, a, w, tile_k(K, block_k))
    check_sc_mac_variants(g)
    return lines


def check_sc_mac_variants(g):
    """Kernel == plain version bit for bit on the paths the timed cases do
    not take: int32 operands past both ends of the table (clamped), fewer
    than 256 levels (the 16-byte path's clamp), streams of 1 word (padded to
    2), 4 and 32 words (one copy of B's LUT), levels past 255, N off the
    16-byte grid, one row, and trees of 2, 4 and 16 leaves."""
    from repro_torch.core import stochastic as sc
    from repro_torch.core.odin_linear import get_luts
    from repro_torch.kernels.sc_mac import sc_mac_cuda, sc_mac_plain, tile_k

    cases = [  # stream, levels, M, K, N, block_k, dtype, operand range
        (256, 256, 2, 300, 96, 32, torch.int32, (-40, 300)),
        (256, 256, 90, 70, 5, 0, torch.int32, (-40, 300)),
        (256, 200, 2, 500, 64, 32, torch.uint8, (0, 256)),
        (256, 256, 3, 100, 70, 32, torch.uint8, (0, 256)),
        (256, 256, 1, 1000, 48, 32, torch.uint8, (0, 256)),
        (256, 256, 5, 200, 33, 2, torch.uint8, (0, 256)),
        (256, 256, 40, 90, 6, 4, torch.uint8, (0, 256)),
        (256, 256, 4, 130, 20, 16, torch.uint8, (0, 256)),
        (128, 100, 4, 150, 40, 0, torch.uint8, (0, 256)),
        (32, 33, 3, 80, 17, 8, torch.int32, (-5, 40)),
        (256, 257, 2, 120, 48, 32, torch.int32, (-9, 300)),
        (1024, 257, 2, 120, 40, 32, torch.int32, (-9, 300)),
        (1024, 257, 50, 40, 3, 0, torch.int32, (-9, 300)),
    ]
    for stream, levels, M, K, N, block_k, dt, (lo, hi) in cases:
        spec = sc.StreamSpec(stream, levels)
        luts = get_luts(stream, levels, 1, device="cuda")
        a = torch.randint(lo, hi, (M, K), generator=g, device="cuda", dtype=torch.int32).to(dt)
        w = torch.randint(lo, hi, (K, N), generator=g, device="cuda", dtype=torch.int32).to(dt)
        bk = tile_k(K, block_k)
        out = sc_mac_cuda(a, w, *luts, block_k=bk)
        ref = sc_mac_plain(a, w, *luts, spec, bk)
        if not torch.equal(out, ref):
            raise AssertionError(f"sc_mac variant stream {stream} levels {levels} {M}x{K}x{N} "
                                 f"bk {bk} {dt}: kernel != plain "
                                 f"(max abs {(out - ref).abs().max().item()})")
    log(f"sc_mac: kernel == plain version bit for bit in {len(cases)} variant cases")


def adaptive_iters(fn, target_ms: float = 20.0, most: int = 100) -> int:
    """Calls of ``fn`` that fill about ``target_ms`` of device time, from one
    eager call after a warm-up (at least 1, at most ``most``)."""
    fn()
    ms = cuda_ms(fn, 1, warmup=0)
    return max(1, min(most, int(target_ms / max(ms, 1e-3))))


def sc_mac_bound(M, K, N, bk, W):
    """Least device time of ``sc_mac`` on this card, from its 32-bit lane
    operations and its bytes.  The MUX tree's root takes each bit from
    exactly one leaf, so it is the OR of the leaves' products masked by
    disjoint select masks: one AND-OR (a single LOP3) per leaf word, one
    popcount per tree word, one B→S gather per operand element and word.
    ``tree_ops`` counts the tree as it is drawn (an AND per leaf word, a mux
    per node, a popcount per tree word), kept beside it for comparison."""
    n_tiles = -(-K // bk)
    gathers = W * (M * K + K * N)
    ops = M * N * W * (K + n_tiles) + gathers
    tree_ops = M * N * W * (K + n_tiles * (bk - 1) + n_tiles) + gathers
    nbytes = M * K + K * N + 4 * M * N + 4 * (2 * 256 * W + bk.bit_length() * W)
    t_ops, t_bytes = ops / INT32_OPS, nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_ms_tree_count": max(t_bytes, tree_ops / INT32_OPS) * 1e3,
            "int32_ops": ops, "int32_ops_tree_count": tree_ops, "bytes": nbytes}


def sc_plan_report(M, K, N, bk, W):
    """The kernel's launch plan for one shape (tile, splits), where the
    wrapper has one."""
    from repro_torch.kernels.sc_mac import sc_mac as sc_mod
    plan = getattr(sc_mod, "sc_plan", None)
    if plan is None:
        return {}
    from repro_torch.kernels.paged_attn.ops import sm_count
    p = plan(M, N, K, bk, W, sm_count(0))
    return {"plan": {k: p[k] for k in ("swap", "mm", "nt", "threads", "row_blocks",
                                       "col_blocks", "chunks_per_split", "n_splits",
                                       "group", "ctas")}}


def time_sc_mac(name, a, w, bk):
    """``sc_mac`` on uint8 rails ``a`` [M, K] and ``w`` [K, N] in trees of
    ``bk`` leaves: kernel == plain version bit for bit, both timed by
    CUDA-graph replay (plain, kernel, kernel, plain), the bound of the
    function and the kernel's plan."""
    from repro_torch.core import stochastic as sc
    from repro_torch.core.odin_linear import get_luts
    from repro_torch.kernels.sc_mac import sc_mac_plain, sc_mac_popcounts

    spec = sc.StreamSpec()
    lut_a, lut_w, selects = get_luts(256, 256, 0, device="cuda")
    (M, K), N = a.shape, w.shape[1]

    def kernel():
        return sc_mac_popcounts(a, w, lut_a, lut_w, selects, spec, bk)

    def plain():
        return sc_mac_plain(a, w, lut_a, lut_w, selects, spec, bk)

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    if not torch.equal(out, ref):
        raise AssertionError(f"sc_mac {name}: kernel popcounts differ from the plain "
                             f"version (max abs {err})")
    ki, pi = adaptive_iters(kernel), adaptive_iters(plain, most=20)
    reps = 3 if pi > 1 else 1
    p1 = graph_ms(plain, pi, reps=reps)
    k1 = graph_ms(kernel, ki)
    k2 = graph_ms(kernel, ki)
    p2 = graph_ms(plain, pi, reps=reps)
    line = {"case": name, "M": M, "K": K, "N": N, "block_k": bk, "tiles": -(-K // bk),
            "max_abs_err": err, "ms": min(k1, k2), "plain_ms": min(p1, p2),
            "kernel_ms_runs": [k1, k2], "plain_ms_runs": [p1, p2],
            "timer": "cuda graph replay", "eager_ms": cuda_ms(kernel, ki), "library_ms": None,
            **sc_mac_bound(M, K, N, bk, spec.n_words), **sc_plan_report(M, K, N, bk,
                                                                        spec.n_words)}
    if name in SC_PROFILED:
        line["kernel_us_by_name"] = kernel_us(kernel)
    log("sc_mac check:", json.dumps(line))
    return line


# sc_mac cases whose device time is also split by kernel (the launch's
# memset of a split K apart from the kernel) by the profiler
SC_PROFILED = ("cnn1_conv0_b64_tree", "cnn1_fc3_b64_hybrid32", "phi4_k_2x3072x1024_hybrid32",
               "phi4_gate_2x3072x8192_hybrid32")


def check_int8_mm():
    """The int8 GEMM against its plain version, bit for bit (``torch.equal``:
    the int32 sums are exact on both sides and the epilogue rounds them the
    same way), at the kernel bench's 128x256x128, phi4's up projection at 8
    rows (8x3072x8192), a ragged 257x1000x129 and 4096^3.  Yardsticks where
    ``torch._int_mm`` takes the shape, each + the scale multiply: with w
    row-major [K, N] as the function receives it, and with w stored
    transposed (``wt = w.t().contiguous()`` made outside the timed call, as
    a deployment stores a weight); the faster is ``library_ms``.  Bound:
    2·M·N·K at the int8 tensor-core peak against the bytes (int8 operands,
    float32 scales and output).  The kernel's time includes the wrapper's
    writing of wᵀ (also timed alone).  Times are device times of CUDA graph
    replays (``graph_ms``), the kernel's eager time a call beside them."""
    from repro_torch.kernels.int8_mm import int8_mm_fused, int8_mm_ref
    from repro_torch.kernels.int8_mm.int8_mm import k_major_operands

    g = torch.Generator(device="cuda").manual_seed(8)
    lines = {}
    for M, K, N in ((128, 256, 128), (8, 3072, 8192), (257, 1000, 129), (4096, 4096, 4096)):
        a = torch.randint(-127, 128, (M, K), generator=g, device="cuda", dtype=torch.int32).to(torch.int8)
        w = torch.randint(-127, 128, (K, N), generator=g, device="cuda", dtype=torch.int32).to(torch.int8)
        sa = torch.rand(M, generator=g, device="cuda") * 0.999 + 0.001
        sw = torch.rand(N, generator=g, device="cuda") * 0.999 + 0.001
        out, ref = int8_mm_fused(a, w, sa, sw), int8_mm_ref(a, w, sa, sw)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if not torch.equal(out, ref):
            raise AssertionError(f"int8_mm {M}x{K}x{N}: kernel != plain version "
                                 f"({int((out != ref).sum())} elements, max abs {err:.3e})")
        wt = w.t().contiguous()
        yardsticks = {"row_major_w": lambda: torch._int_mm(a, w),
                      "stored_transposed_w": lambda: torch._int_mm(a, wt.t())}
        try:                                   # the int32 product alone, no epilogue
            int_mm_only = graph_ms(lambda: torch._int_mm(a, wt.t()), 5 if M >= 1024 else 50)
        except RuntimeError:
            int_mm_only = None
        ops = 2 * M * N * K
        nbytes = M * K + K * N + 4 * (M + N) + 4 * M * N
        iters = 5 if M * N * K >= 1 << 30 else 50
        p1 = graph_ms(lambda: int8_mm_ref(a, w, sa, sw), iters)
        k1 = graph_ms(lambda: int8_mm_fused(a, w, sa, sw), iters)
        k2 = graph_ms(lambda: int8_mm_fused(a, w, sa, sw), iters)
        p2 = graph_ms(lambda: int8_mm_ref(a, w, sa, sw), iters)
        prep = graph_ms(lambda: k_major_operands(a, w), iters)
        lib, lib_err = {}, {}
        for name, mm in yardsticks.items():
            try:
                y = mm().float() * (sa[:, None] * sw[None, :])
            except RuntimeError as e:          # shapes torch._int_mm does not take
                lib[name], lib_err[name] = None, str(e).splitlines()[0][:120]
                continue
            lib_err[name] = (y - ref).abs().max().item()
            lib[name] = graph_ms(lambda mm=mm: mm().float() * (sa[:, None] * sw[None, :]),
                                 iters)
        timed = [t for t in lib.values() if t is not None]
        line = {"case": f"{M}x{K}x{N}", "max_abs_err": err, "bit_for_bit": True,
                "ms": min(k1, k2), "plain_ms": min(p1, p2), "timer": "cuda graph replay",
                "kernel_ms_runs": [k1, k2], "plain_ms_runs": [p1, p2],
                "w_transpose_ms": prep, "eager_ms": cuda_ms(lambda: int8_mm_fused(a, w, sa, sw),
                                                            iters),
                "library_ms": min(timed) if timed else None, "library_ms_by_layout": lib,
                "int_mm_stored_transposed_without_scale_ms": int_mm_only,
                "library_max_abs_err": lib_err,
                "bound_ms": max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS) * 1e3,
                "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / INT8_OPS else "operations",
                "tops": ops / (min(k1, k2) * 1e-3) / 1e12}
        log("int8_mm check:", json.dumps(line))
        lines[line["case"]] = line
    return lines


def check_rail_dot():
    """``int_matmul`` in float64 on the card must equal the CPU's int32
    matmul bit for bit: the int8 mode's rail dot (uint8 0..255 operands) at
    CNN1's shapes, and the int8 operands of ``int8_mm``'s plain version."""
    from repro_torch.core import stochastic as sc
    g = torch.Generator(device="cuda").manual_seed(3)
    for M, K, N, lo, hi, dt in ((64 * 28 * 28, 25, 4, 0, 256, torch.uint8),
                                (64, 784, 70, 0, 256, torch.uint8),
                                (64, 70, 10, 0, 256, torch.uint8),
                                (128, 256, 128, -127, 128, torch.int8)):
        a = torch.randint(lo, hi, (M, K), generator=g, device="cuda", dtype=torch.int32).to(dt)
        w = torch.randint(lo, hi, (K, N), generator=g, device="cuda", dtype=torch.int32).to(dt)
        if not torch.equal(sc.int_matmul(a, w).cpu(), torch.matmul(a.cpu().int(), w.cpu().int())):
            raise AssertionError(f"int_matmul {dt} {M}x{K}x{N}: card != CPU int32 matmul")
    log("int_matmul (float64 on the card) == CPU int32 matmul: uint8 rails at CNN1's "
        "shapes, int8 at 128x256x128")


# ---------------------------------------------------------------------------
# phases 8-9: the CNN path and the kernel bench
# ---------------------------------------------------------------------------

def cnn_experiment():
    """The paper's experiment through ``launch/odin_inference.run`` on the
    card, with the JAX suite's accuracy thresholds (tests/test_system.py)."""
    from repro_torch.core.odin_linear import get_luts
    from repro_torch.kernels.sc_mac import sc_mac_cuda
    from repro_torch.launch import odin_inference as oi
    from repro_torch.nn.cnn import cnn_forward, mac_layers

    n_eval = 8
    sc_mac_cuda.launches = 0
    out = oi.run(steps=300, batch=64, n_eval=n_eval, eval_batch=64, device="cuda", log=log)
    torch.cuda.synchronize()
    launches = sc_mac_cuda.launches
    res, topo = out["result"], out["topology"]
    acc = res["accuracy"]
    forwards = n_eval + 1                       # the evaluation batches and one warm-up
    expected = sum((4 if cfg.signed_activations else 2) * mac_layers(topo) * forwards
                   for _, cfg in oi.MODES if cfg is not None and cfg.mode == "sc")
    if launches != expected:
        raise AssertionError(f"sc_mac launches {launches} != rails x MAC layers x forwards "
                             f"= {expected}")
    checks = {"fp32 > 0.8": acc["fp32"] > 0.8,
              "|fp32 - int8| < 0.05": abs(acc["fp32"] - acc["int8"]) < 0.05,
              "sc hybrid/8 > 0.55": acc["sc_hybrid8"] > 0.55,
              "sc full tree < 0.5": acc["sc_full_tree"] < 0.5}
    # one batch on the card (kernels) against the CPU plain path, bit for bit,
    # in every ODIN mode
    b = out["batches"][0]
    params_cpu = {k: v.detach().cpu() for k, v in out["params"].items()}
    parity = {}
    for name, cfg in oi.MODES:
        if cfg is None:
            continue
        with torch.no_grad():
            card = cnn_forward(out["params"], b["image"], topo, cfg).cpu()
            cpu = cnn_forward(params_cpu, b["image"].cpu(), topo, cfg,
                              luts=get_luts(256, 256, 0, device="cpu"))
        parity[name] = (card - cpu).abs().max().item()
        if not torch.equal(card, cpu):
            raise AssertionError(f"{name} logits: card != CPU plain path "
                                 f"(max abs {parity[name]:.3e})")
    line = dict(res, sc_mac_launches=launches, sc_mac_launches_expected=expected,
                thresholds=checks, card_vs_cpu_max_abs=parity)
    log("CNN1 experiment:", json.dumps(line))
    profile_cnn(out["params"], b["image"], topo)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"CNN1 accuracy thresholds failed: {failed}; {acc}")
    return launches, line


def profile_cnn(params, images, topo):
    """Device time against wall time of one CNN1 forward (batch 64) in each
    ODIN mode: four forwards timed unprofiled, four under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import odin_inference as oi
    from repro_torch.nn.cnn import cnn_forward

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    report = {}
    for name, cfg in oi.MODES:
        def four():
            torch.cuda.synchronize()
            t = time.perf_counter()
            with torch.no_grad():
                for _ in range(4):
                    cnn_forward(params, images, topo, cfg)
            torch.cuda.synchronize()
            return (time.perf_counter() - t) / 4

        four()
        wall = four()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            four()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        busy = sum(dev_us(e) for e in kernels) / 4e3
        top = sorted(kernels, key=dev_us, reverse=True)[:3]
        report[name] = {"wall_ms": wall * 1e3, "device_ms": busy,
                        "device_busy_share": busy / (wall * 1e3),
                        "device_ops": sum(e.count for e in kernels) / 4,
                        "top_device_ms": {e.key[:50]: dev_us(e) / 4e3 for e in top}}
    log("CNN1 forward profile (batch 64, per forward):", json.dumps(report))


def kernel_bench():
    """The kernel bench entry point, the main path of ``int8_mm``."""
    from repro_torch.kernels.int8_mm import int8_mm_cuda
    from repro_torch.launch import kernel_bench as kb

    int8_mm_cuda.launches = 0
    out = kb.run(device="cuda")
    torch.cuda.synchronize()
    launches = int8_mm_cuda.launches
    if launches <= 0:
        raise AssertionError("kernel bench: int8_mm was not launched")
    log("kernel bench:", json.dumps(dict(out, int8_mm_launches=launches)))
    return launches


# ---------------------------------------------------------------------------
# phase 8: the act_pool kernel
# ---------------------------------------------------------------------------

def _avg_tie_windows(device):
    """2x2 windows whose ReLU'd sums run over 0..1020 (every sum 2 mod 4 is
    an exact .5 average), zeros stored as -5 for the ReLU to clip."""
    sums = torch.arange(0, 1021, device=device)
    win = torch.zeros((sums.numel(), 4), dtype=torch.int64, device=device)
    rest = sums.clone()
    for q in range(4):
        win[:, q] = torch.clamp(rest, max=255)
        rest -= win[:, q]
    win = torch.where(win == 0, -5, win)
    x = win.reshape(-1, 2, 2).permute(1, 0, 2).reshape(2, -1)
    return x.to(torch.int32).reshape(1, 2, -1, 1).contiguous()


def check_act_pool():
    """The activation + pooling kernel against its plain version, bit for
    bit.  Its path is its own entry point ``act_pool`` (no model path of the
    JAX package launches it): every act x pool_kind at p=2 on CNN1's conv
    map at batch 64, CNN2's and a VGG-scale map, the launch count set to 0
    just before and read just after.  Then cases that only compare: p=3 and
    4, p=5, 6 and 7 (the kernel's loop for any pool size, not unrolled) on
    maps of four channels, of one and at an odd storage offset, C from 1 to
    65, odd output widths, an input at an odd storage offset (the kernel's
    4-byte path), maps smaller than one CTA and maps that take several
    passes of the grid-stride loop, the whole tanh domain, avg ties, the
    int32 extremes; and in every case the launcher's own plan equal to
    ``launch_plan``.  Bound: bytes (each int32 input read once, each output
    written once); the operations (a clamp and a max or add per
    input for relu, a float division, tanhf, a multiply, a rint and two
    clamps per input for tanh, counted as 24 float32 operations) take less.
    No single PyTorch call computes the function: the pooling operators take
    floating point only and no 8-bit activation, so there is no library
    time.  Times are device times by CUDA-graph replay, every act x pool
    kind on each map, each with its share of the bound, beside the
    per-kernel floor (a one-element add timed the same way); on the small
    maps also the profiler's device time of the kernel and of the add."""
    from repro_torch.kernels.act_pool import (act_pool, act_pool_cuda, act_pool_ref, kernel_plan,
                                              launch_plan)
    from repro_torch.kernels.act_pool.act_pool import ACTS, POOL_KINDS

    g = torch.Generator(device="cuda").manual_seed(13)

    def rand(shape, lo=-300, hi=600):
        return torch.randint(lo, hi, shape, generator=g, device="cuda", dtype=torch.int32)

    maps = {"cnn1_conv_b64": rand((64, 28, 28, 4)), "cnn2_conv_b64": rand((64, 22, 22, 10)),
            "vgg_8x224x224x64": rand((8, 224, 224, 64))}
    variants = [(a, k) for a in ACTS for k in POOL_KINDS]
    act_pool_cuda.launches = 0
    outs = {(m, a, k): act_pool(x, pool=2, act=a, pool_kind=k)
            for m, x in maps.items() for a, k in variants}
    torch.cuda.synchronize()
    launches = act_pool_cuda.launches
    if launches != len(outs):
        raise AssertionError(f"act_pool launches {launches} != {len(outs)} calls")
    checked = []
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def plan_of(name, x, pool):
        args = (x.shape, pool, x.data_ptr() % 16 == 0, n_sm)
        plan, own = launch_plan(*args), kernel_plan(*args)
        if plan != own:
            raise AssertionError(f"act_pool {name} p={pool}: launch_plan {plan} != "
                                 f"launcher's {own}")
        return plan

    def hold(name, out, x, pool, act, kind):
        ref = act_pool_ref(x, pool, act, kind)
        if out.shape != ref.shape:
            raise AssertionError(f"act_pool {name}: shape {tuple(out.shape)} != "
                                 f"{tuple(ref.shape)}")
        err = (out.long() - ref.long()).abs().max().item()
        if err:
            raise AssertionError(f"act_pool {name} {act}/{kind} p={pool}: kernel != plain "
                                 f"(max abs {err})")
        checked.append(err)

    for (m, a, k), out in outs.items():
        hold(m, out, maps[m], 2, a, k)
    tanh_domain = torch.arange(-1024, 4096, device="cuda", dtype=torch.int32).reshape(1, 80, 64, 1)
    tanh_wide = torch.arange(-2 ** 16, 2 ** 16, device="cuda",
                             dtype=torch.int32).reshape(1, 256, 512, 1)
    extremes = rand((2, 6, 6, 8))
    extremes[0, ::2] = 2 ** 31 - 1
    extremes[1, :, ::3] = -(2 ** 31 - 1)
    extremes[0, 1, 1, 1] = -2 ** 31
    # a contiguous tensor one int32 past a 16-byte boundary: 4-byte items
    odd_offset = rand((2 * 8 * 8 * 8 + 1,))[1:].view(2, 8, 8, 8)
    odd_offset_p5 = rand((2 * 10 * 15 * 8 + 1,))[1:].view(2, 10, 15, 8)
    extra = [("p3", rand((2, 12, 12, 16)), 3, variants),
             ("p4", rand((2, 16, 16, 8)), 4, variants),
             ("p5_vec", rand((2, 10, 15, 8)), 5, variants),
             ("p5_c1", rand((2, 10, 15, 1)), 5, variants),
             ("p5_odd_offset", odd_offset_p5, 5, variants),
             ("p6_vec", rand((1, 12, 18, 8)), 6, variants),
             ("p7_vec", rand((2, 14, 21, 4)), 7, variants),
             ("p7_c1", rand((1, 14, 21, 1)), 7, variants),
             ("p7_c3", rand((1, 7, 14, 3)), 7, variants),
             ("c3", rand((4, 8, 8, 3)), 2, variants),
             ("c10", rand((2, 6, 6, 10)), 2, variants),
             *[(f"c{C}_8x8", rand((2, 8, 8, C)), 2, variants) for C in (1, 2, 3, 5, 8, 12, 65)],
             ("odd_wo_7", rand((2, 6, 14, 8)), 2, variants),
             ("odd_wo_5_p3", rand((1, 9, 15, 4)), 3, variants),
             ("odd_offset", odd_offset, 2, variants),
             ("one_item_vec", rand((1, 2, 2, 4)), 2, variants),
             ("three_items_words", rand((1, 2, 2, 3)), 2, variants),
             ("passes_vec", rand((32, 64, 64, 64)), 2, variants),
             ("passes_words", rand((8, 64, 64, 65)), 2, variants),
             ("tanh_domain", tanh_domain, 1, [("tanh", "max")]),
             ("tanh_domain", tanh_domain, 2, [("tanh", "avg")]),
             ("tanh_wide", tanh_wide, 1, [("tanh", "max"), ("tanh", "avg")]),
             ("tanh_wide", tanh_wide, 2, [("tanh", "avg")]),
             ("avg_ties", _avg_tie_windows("cuda"), 2, [("relu", "avg")]),
             ("int32_extremes", extremes, 2, variants),
             ("int32_extremes", extremes, 3, [("relu", "avg"), ("tanh", "avg")])]
    for name, x, pool, vs in extra:
        for a, k in vs:
            hold(name, act_pool(x, pool=pool, act=a, pool_kind=k), x, pool, a, k)
    ties = act_pool(_avg_tie_windows("cuda"), pool=2, pool_kind="avg")[0, 0, :, 0].cpu()
    if ties[2].item() != 0 or ties[6].item() != 2:
        raise AssertionError(f"act_pool avg ties: 0.5 -> {ties[2].item()}, 1.5 -> {ties[6].item()}")
    plans = {name: plan_of(name, x, pool) for name, x, pool, _ in extra}
    plans.update({m: plan_of(m, x, 2) for m, x in maps.items()})
    expect = {"odd_offset": not plans["odd_offset"]["vec"],
              "p5_odd_offset": not plans["p5_odd_offset"]["vec"],
              "p5_vec": plans["p5_vec"]["vec"], "p7_c1": not plans["p7_c1"]["vec"],
              "c8_8x8": plans["c8_8x8"]["vec"],
              "cnn2_conv_b64": not plans["cnn2_conv_b64"]["vec"],
              "one_item_vec": plans["one_item_vec"]["items"] == 1,
              "three_items_words": plans["three_items_words"]["items"] == 3,
              "passes_vec": plans["passes_vec"]["vec"] and plans["passes_vec"]["passes"] >= 2,
              "passes_words": (not plans["passes_words"]["vec"]
                               and plans["passes_words"]["passes"] >= 2)}
    if not all(expect.values()):
        raise AssertionError(f"act_pool plans: {expect} {plans}")
    log("act_pool plans:", json.dumps(plans))

    one = torch.zeros(1, dtype=torch.int32, device="cuda")
    floor_runs = [graph_ms(lambda: one + 1, 50), graph_ms(lambda: one + 1, 50)]
    floor_ms = min(floor_runs)
    log("per-kernel floor (one-element add, cuda graph replay):",
        json.dumps({"ms": floor_ms, "runs": floor_runs,
                    "profiler_us": kernel_us(lambda: one + 1)}))
    lines = {}
    for m, a, k in [(m, a, k) for m in maps for a, k in variants]:
        x = maps[m]
        nbytes = 4 * x.numel() + 4 * x.numel() // 4
        ops = x.numel() * (24 if a == "tanh" else 3)
        t_ops = ops / (F32_FLOPS if a == "tanh" else INT32_OPS)

        def kernel():
            return act_pool(x, pool=2, act=a, pool_kind=k)

        def plain():
            return act_pool_ref(x, 2, a, k)

        # device time by graph replay (plain, kernel, kernel, plain), the
        # kernel's eager time a call (host included) beside it
        p1, k1, k2, p2 = (graph_ms(plain, 10), graph_ms(kernel, 50), graph_ms(kernel, 50),
                          graph_ms(plain, 10))
        bound_ms = max(nbytes / HBM_BYTES_PER_S, t_ops) * 1e3
        line = {"case": f"{m}_{a}_{k}", "max_abs_err": max(checked), "ms": min(k1, k2),
                "plain_ms": min(p1, p2), "kernel_ms_runs": [k1, k2], "plain_ms_runs": [p1, p2],
                "timer": "cuda graph replay", "eager_ms": cuda_ms(kernel, 50),
                "bound_ms": bound_ms,
                "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= t_ops else "operations",
                "bound_share": bound_ms / min(k1, k2),
                "at_least_half_bound": bound_ms / min(k1, k2) >= 0.5,
                "floor_ms": floor_ms, "over_floor_ms": min(k1, k2) - floor_ms,
                "bytes": nbytes, "library_ms": None, "plan": plans[m]}
        if m != "vgg_8x224x224x64":   # the small maps: the kernel's own span
            line["profiler_us"] = kernel_us(kernel)
        log("act_pool timing:", json.dumps(line))
        lines[line["case"]] = line
    log(f"act_pool: kernel == plain version bit for bit in {len(checked)} cases; "
        f"{launches} launches through the entry point")
    return launches, lines


# ---------------------------------------------------------------------------
# phase 9: odin_linear at the LM's widths, and the LM in the int8/sc modes
# ---------------------------------------------------------------------------

PHI4_PROJECTIONS = (("q", 3072, 3072), ("k", 3072, 1024), ("v", 3072, 1024),
                    ("o", 3072, 3072), ("gate", 3072, 8192), ("up", 3072, 8192),
                    ("down", 8192, 3072))


class _PlainScRoute:
    """Stands in for ``odin_linear``'s ``sc_mac`` entry: the plain version on
    the card, for the comparison of the two routes."""

    @staticmethod
    def sc_mac_popcounts(a_q, w_q, lut_a, lut_w, selects, spec, block_k):
        from repro_torch.kernels.sc_mac import sc_mac_plain
        return sc_mac_plain(a_q, w_q, lut_a, lut_w, selects, spec, block_k)


SC_ROWS = (2, 8, 16, 32)        # rows of the sc serving path: decode, 8 slots, tiles
SC_TIMED_ROWS = (2, 8)          # the sc decode step's rows, and a decode step of 8 slots


class _RecordingScRoute:
    """Passes ``odin_linear``'s ``sc_mac`` entry through, recording the rows
    of every call, so that the serving path's shapes can be held against
    those that ``check_odin_linear_full_width`` checked."""

    def __init__(self, inner):
        self.inner, self.rows = inner, set()

    def sc_mac_popcounts(self, a_q, *args):
        self.rows.add(a_q.shape[0])
        return self.inner.sc_mac_popcounts(a_q, *args)


def check_odin_linear_full_width():
    """``odin_linear`` at phi4-mini-3.8b's seven projection shapes, bit for
    bit: sc with the kernel against sc with the plain version on the card (4
    signed rails, trees of 32) at every row count of ``SC_ROWS`` (2: the sc
    serving path's decode step; 16 and 32: its prefill tiles; 8: a decode
    step of 8 slots), int8 on the card (float64 rail dot) against int8 on
    the CPU (int32) at 8 rows.  Then ``sc_mac`` timed on each projection's
    a+ . w+ rails at 2 rows (the sc decode step's) and 8 against its bound.
    Returns the timing lines, keyed (projection, rows), and the row counts
    checked."""
    from repro_torch.core.odin_linear import OdinConfig, odin_linear
    from repro_torch.core.quant import quantize_signed_tworail
    from repro_torch.kernels.sc_mac import sc_mac_cuda

    odin_module = sys.modules["repro_torch.core.odin_linear"]
    g = torch.Generator(device="cuda").manual_seed(21)
    cfg = OdinConfig(mode="sc")
    lines = {}
    for name, K, N in PHI4_PROJECTIONS:
        w = torch.randn((K, N), generator=g, device="cuda") * K ** -0.5
        for M in SC_ROWS:
            x = torch.randn((M, K), generator=g, device="cuda")
            if M == 8:
                y8 = odin_linear(x, w, OdinConfig(mode="int8"))
                y8_cpu = odin_linear(x.cpu(), w.cpu(), OdinConfig(mode="int8"))
                if not torch.equal(y8.cpu(), y8_cpu):
                    raise AssertionError(
                        f"odin_linear int8 {name}: card != CPU "
                        f"(max abs {(y8.cpu() - y8_cpu).abs().max().item():.3e})")
            sc_mac_cuda.launches = 0
            ys = odin_linear(x, w, cfg)
            torch.cuda.synchronize()
            if sc_mac_cuda.launches != 4:
                raise AssertionError(f"odin_linear sc {name} M={M}: {sc_mac_cuda.launches} "
                                     "sc_mac launches, not one per rail pair (4)")
            kernel_route = odin_module.sc_mac_ops
            odin_module.sc_mac_ops = _PlainScRoute
            try:
                yp = odin_linear(x, w, cfg)
            finally:
                odin_module.sc_mac_ops = kernel_route
            if not torch.equal(ys, yp) or not torch.isfinite(ys).all():
                raise AssertionError(f"odin_linear sc {name} M={M}: kernel route != plain "
                                     f"route (max abs {(ys - yp).abs().max().item():.3e})")
            if M in SC_TIMED_ROWS:
                a_pos = quantize_signed_tworail(x)[0]
                w_pos = quantize_signed_tworail(w)[0]
                lines[(name, M)] = time_sc_mac(f"phi4_{name}_{M}x{K}x{N}_hybrid32", a_pos,
                                               w_pos, 32)
    log(f"odin_linear at phi4-mini's projections: sc kernel route == plain route at "
        f"{list(SC_ROWS)} rows, int8 card == CPU at 8 rows, bit for bit")
    return lines, set(SC_ROWS)


def serve_odin(cfg, params, prompts, exact_streams, rng, sc_rows_checked):
    """The LM in ODIN's int8 and sc modes through ``ServingEngine(odin_mode=)``
    at full width.  int8: the smoke traffic's 8 prompts of 512 tokens, 32
    greedy tokens each, and a decode profile; tokens that agree with the
    exact-mode run are counted (informative: an 8-bit model is another
    model).  sc (stream 256, trees of 32, signed rails): 2 slots, 2 prompts
    of 16 tokens, 4 greedy tokens each, every dispatch timed; every forward
    launches ``sc_mac`` once per rail pair and projection (4 x 7 x layers),
    and a decode profile gives sc_mac's share of the device time.  Every row
    count that the sc run gives ``sc_mac`` must be among
    ``sc_rows_checked``, those at which ``check_odin_linear_full_width``
    held the kernel route against the plain route."""
    out = {}
    r = serve(cfg, params, prompts, 32, odin_mode="int8")
    s = r["summary"]
    agree = sum(a == b for rid, st in r["streams"].items()
                for a, b in zip(st, exact_streams[rid]))
    first = [next((t for t, (a, b) in enumerate(zip(st, exact_streams[rid])) if a != b),
                  len(st)) for rid, st in r["streams"].items()]
    line = {"mode": "int8", "requests": 8, "prompt": 512, "generated": 32,
            "wall_s": r["wall"], "decode_tokens_per_s": s["decode_tokens_per_s"],
            "ttft_s": s["ttft_s"], "tpot_s": s["tpot_s"], "peak_memory_gb": r["peak"] / 1e9,
            "forwards": r["forwards"], "paged_attn_launches": r["launches"],
            "sc_mac_launches": r["sc_launches"],
            "tokens_equal_to_exact": agree, "tokens": 8 * 32,
            "steps_before_first_difference_from_exact": first}
    if r["sc_launches"]:
        raise AssertionError("int8 mode launched sc_mac")
    log("int8 serving:", json.dumps(line))
    line["decode_profile"] = profile_decode(
        params, cfg.with_overrides(odin_mode="int8"), prompts, block=2, max_new=12,
        label="int8 decode profile (8 slots, 2 steps each block)")
    out["int8"] = dict(line, launches=r["launches"])
    out["sc"] = serve_odin_sc(cfg, params, prompts, sc_rows_checked)
    return out


def serve_odin_sc(cfg, params, prompts, sc_rows_checked):
    """The sc half of :func:`serve_odin`: 2 slots, 2 prompts of 16 tokens, 4
    greedy tokens each, then the sc decode profile."""
    sc_prompts = [p[:16] for p in prompts[:2]]
    odin_module = sys.modules["repro_torch.core.odin_linear"]
    kernel_route = odin_module.sc_mac_ops
    odin_module.sc_mac_ops = route = _RecordingScRoute(kernel_route)
    try:
        r = serve(cfg, params, sc_prompts, 4, slots=2, odin_mode="sc", timed=True)
    finally:
        odin_module.sc_mac_ops = kernel_route
    if not route.rows <= sc_rows_checked:
        raise AssertionError(f"sc serving gave sc_mac {sorted(route.rows)} rows; only "
                             f"{sorted(sc_rows_checked)} were held against the plain route")
    s = r["summary"]
    per_forward = 4 * len(PHI4_PROJECTIONS) * cfg.n_layers
    n_fwd = r["forwards"] + r["prefill_forwards"]
    if r["sc_launches"] != per_forward * n_fwd:
        raise AssertionError(f"sc_mac launches {r['sc_launches']} != {per_forward} x "
                             f"{n_fwd} forwards")
    t = r["times"]
    line = {"mode": "sc", "requests": 2, "prompt": 16, "generated": 4, "wall_s": r["wall"],
            "prefill_dispatch_s": t["_mixed"] + t["_prefill"], "decode_step_s": t["_decode"],
            "decode_tokens_per_s": s["decode_tokens_per_s"], "ttft_s": s["ttft_s"],
            "peak_memory_gb": r["peak"] / 1e9, "forwards": n_fwd,
            "sc_mac_launches": r["sc_launches"], "sc_mac_launches_per_forward":
            r["sc_launches"] / n_fwd, "sc_mac_rows": sorted(route.rows),
            "paged_attn_launches": r["launches"],
            "streams": r["streams"]}
    log("sc serving:", json.dumps(line))
    line["decode_profile"] = profile_decode(
        params, cfg.with_overrides(odin_mode="sc"), sc_prompts, block=1, max_new=8,
        label="sc decode profile (2 slots, 1 step each block)")
    return dict(line, launches=r["launches"])


# ---------------------------------------------------------------------------
# phase 10: the guarded decode step and fault-plan replay
# ---------------------------------------------------------------------------

def guarded_faults(cfg, params, rng):
    """Full-width exact mode under fault plans.  A nan_logits event poisons
    one slot's logits in a decode step: that request alone fails
    (``nan_quarantined == 1``, a clean prefix of its fault-free stream) and
    the co-batched streams equal the fault-free run's, a parting accepted
    only at a reported near tie (``check_divergence``).  Then a generated
    chaos plan (seed 0: alloc, swap, clock skew, stuck-at, wear exhaustion
    and nan_logits events) with the degradation ladder on, against a tight
    pool with a swap tier, runs to completion with every request terminal."""
    from repro_torch.serving import FaultEvent, FaultPlan, RequestState

    prompts = list(rng.integers(0, cfg.vocab, size=(4, 128), dtype=np.int32))
    base = serve(cfg, params, prompts, 16, slots=4)
    plan = FaultPlan(events=(FaultEvent(site="nan_logits", step=6, slot=1),))
    hit = serve(cfg, params, prompts, 16, slots=4, all_done=False, fault_plan=plan)
    s = hit["summary"]
    failed = [r for r in hit["requests"] if r.state is RequestState.FAILED]
    if s["faults"]["nan_quarantined"] != 1 or len(failed) != 1 \
            or failed[0].finish_reason != "nan_logits":
        raise AssertionError(f"nan_logits plan: {s['faults']}, failed "
                             f"{[(r.rid, r.finish_reason) for r in failed]}")
    if [f["outcome"] for f in s["fault_plan"]["fired"]] != ["poisoned"]:
        raise AssertionError(f"nan_logits plan fired {s['fault_plan']['fired']}")
    bad = failed[0].rid
    for rid, stream in hit["streams"].items():
        ref = base["streams"][rid]
        if rid == bad:
            if len(stream) >= len(ref):
                raise AssertionError(f"quarantined rid {rid} kept all {len(stream)} tokens")
            ref = ref[:len(stream)]
        check_divergence(params, cfg, prompts[rid], ref, stream, rid,
                         "fault-free vs guarded")
    n_equal = sum(hit["streams"][rid] == base["streams"][rid]
                  for rid in base["streams"] if rid != bad)
    line = {"plan": "nan_logits", "quarantined_rid": bad,
            "quarantined_tokens": len(hit["streams"][bad]),
            "cobatched_streams_equal": n_equal, "cobatched": len(prompts) - 1,
            "faults": s["faults"], "fired": s["fault_plan"]["fired"],
            "forwards": hit["forwards"], "paged_attn_launches": hit["launches"]}
    log("guarded decode:", json.dumps(line))

    chaos = FaultPlan.generate(0, n_steps=64, rate=0.3)
    prompts6 = list(rng.integers(0, cfg.vocab, size=(6, 128), dtype=np.int32))
    c = serve(cfg, params, prompts6, 32, slots=4, max_len=256, all_done=False,
              n_blocks=30, swap_blocks=32, fault_plan=chaos, degrade=True)
    s = c["summary"]
    json.dumps(s, allow_nan=False)
    if sum(s["terminal"].values()) != len(prompts6) \
            or len(s["fault_plan"]["fired"]) != s["faults"]["injected"]:
        raise AssertionError(f"chaos plan: terminal {s['terminal']}, faults {s['faults']}")
    line2 = {"plan": "generated seed 0, degrade on", "terminal": s["terminal"],
             "faults": s["faults"], "sites_fired": sorted({f["site"] for f in
                                                           s["fault_plan"]["fired"]}),
             "outcomes": sorted({f["outcome"] for f in s["fault_plan"]["fired"]}),
             "preemptions": s["preemptions"], "reliability": s["reliability"],
             "degradation": {k: v for k, v in s["degradation"].items() if k != "history"},
             "forwards": c["forwards"], "paged_attn_launches": c["launches"],
             "wall_s": c["wall"]}
    log("chaos plan:", json.dumps(line2))
    return {"guarded_nan": hit["launches"], "chaos": c["launches"]}


# ---------------------------------------------------------------------------
# phases 7-8: the dense KV cache with the static loop, and Hymba
# ---------------------------------------------------------------------------

def serve_dense(cfg, params, prompts, exact_streams):
    """Full-width phi4-mini on the dense live cache: the serving phase's 8
    prompts of 512 tokens with 64 greedy tokens through the engine with
    ``paged=False`` (every layer on dense per-slot K/V rows and plain sdpa,
    no ``paged_attention`` launch), then the same prompts through the static
    loop (``serve_static``: one prefill, 64 lockstep decode steps on dense
    caches); both held against the paged run's streams (``exact_streams``)
    with partings only at reported near ties.  Returns each run's
    ``paged_attention`` launches (0)."""
    from repro_torch.kernels.paged_attn import paged_attention
    from repro_torch.launch.serve import _batch_requests, serve_static

    r = serve(cfg, params, prompts, 64, paged=False)
    s = r["summary"]
    n_dense = compare_streams(params, cfg, prompts, exact_streams, r["streams"],
                              "paged=False vs the paged run")
    static_prompts = [q.prompt for q in _batch_requests(cfg, len(prompts), 512, 64, 0)]
    if not all(np.array_equal(a, b) for a, b in zip(static_prompts, prompts)):
        raise AssertionError("serve_static's prompts are not the serving phase's")
    paged_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    generated, static_tps = serve_static(cfg, batch=len(prompts), prompt_len=512, gen=64,
                                         seed=0, params=params, verbose=False)
    static_wall = time.perf_counter() - t
    static_launches = paged_attention.launches
    if static_launches:
        raise AssertionError(f"the static loop launched paged_attention {static_launches}x")
    if not ((generated >= 0) & (generated < cfg.vocab)).all():
        raise AssertionError("serve_static: token out of range")
    static = {i: [int(x) for x in row] for i, row in enumerate(generated)}
    n_static = compare_streams(params, cfg, prompts, exact_streams, static,
                               "serve_static vs the paged engine run")
    log("dense-cache serving:", json.dumps({
        "requests": len(prompts), "prompt": 512, "generated": 64,
        "engine": {"paged": False, "wall_s": r["wall"],
                   "decode_tokens_per_s": s["decode_tokens_per_s"], "ttft_s": s["ttft_s"],
                   "kv_cache_bytes": s["kv_cache_bytes"], "peak_memory_gb": r["peak"] / 1e9,
                   "mixed_dispatches": s["mixed"]["dispatches"],
                   "paged_attn_launches": r["launches"],
                   "streams_equal_to_paged_run": n_dense},
        "static": {"wall_s": static_wall, "decode_tokens_per_s": static_tps,
                   "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "paged_attn_launches": static_launches,
                   "streams_equal_to_paged_run": n_static}}))
    return {"serve_dense": r["launches"], "serve_static": static_launches}


HYMBA_ARCH = "hymba-1.5b"


def hymba_card_vs_cpu():
    """hymba-1.5b at every published width (d_model 1600, 25 query heads over
    5 KV heads of 64, SSM state 16, d_ff 5504, vocab 32,001) over 2 of its 32
    layers, its first (global) layer and one sliding-window layer, float32
    weights from a seeded generator: the engine's greedy streams on the card
    (``paged_attn`` at G = 5, D = 64 for the global layer, launched once a
    decode-carrying forward; the ring and the SSM in plain PyTorch on the
    card) equal those on the CPU (plain path), and so do the logits of a
    prefill and 3 decode steps on serving caches, within atol/rtol 1e-4 (the
    CPU tests' bound: float32 sums in another order).  Returns the card
    run's launches."""
    import dataclasses

    from repro_torch.launch.steps import init_serving_caches
    from repro_torch.models import lm, registry
    from repro_torch.nn.module import materialize
    from repro_torch.serving import ServingEngine, WorkloadSpec, make_requests
    from repro_torch.tree import tree_map

    full = registry.get_config(HYMBA_ARCH)
    cfg = full.with_overrides(kv_dtype="float32", blocks=(
        full.blocks[0], dataclasses.replace(full.blocks[1], n_layers=1)))
    gen = torch.Generator().manual_seed(0)
    params = tree_map(lambda t: t.float(), materialize(lm.param_spec(cfg), gen, "cpu"))
    spec = WorkloadSpec(n_requests=5, rate=1e9, prompt_buckets=(24, 40), gen_buckets=(8, 20))
    streams, logits = {}, {}
    rng = np.random.default_rng(5)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, size=(2, 40), dtype=np.int32))
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(3, 2, 1), dtype=np.int32))
    tables = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        eng = ServingEngine(cfg, slots=3, max_len=64, block_size=16, params=p,
                            device=dev, prefill_chunk=16)
        reqs = make_requests(cfg, spec, seed=1)
        if dev == "cuda":
            with counting(eng) as c:
                eng.run(reqs)
            c.check(cfg)
        else:
            eng.run(reqs)
        streams[dev] = {r.rid: [int(np.ravel(t)[0]) for t in r.generated] for r in reqs}
        caches = init_serving_caches(cfg, 2, 64, window_headroom=16, round_to=16,
                                     block_size=16, n_blocks=8, device=dev)
        out, caches, _ = lm.forward(p, prompt.to(dev), cfg, caches=caches,
                                    tables=tables.to(dev))
        outs = [out[:, -1]]
        for i in range(3):
            start = torch.full((2, 1), 40 + i, dtype=torch.int32, device=dev)
            out, caches, _ = lm.forward(p, toks[i].to(dev), cfg, caches=caches,
                                        start_pos=start, tables=tables.to(dev))
            outs.append(out[:, -1])
        logits[dev] = torch.stack(outs).cpu()
    if streams["cpu"] != streams["cuda"]:
        raise AssertionError(f"hymba 2 layers: card {streams['cuda']} != "
                             f"cpu {streams['cpu']}")
    err = (logits["cuda"] - logits["cpu"]).abs()
    bound = 1e-4 + 1e-4 * logits["cpu"].abs()
    if not bool((err <= bound).all()):
        raise AssertionError(f"hymba 2 layers: card logits off the CPU's by "
                             f"{err.max():.3e}")
    line = {"layers": "1 global + 1 window of 32", "dtype": "float32",
            "streams_equal": True, "tokens": sum(len(s) for s in streams["cuda"].values()),
            "logits_max_abs_err": err.max().item(), "forwards_through_kernel": c.forwards,
            "paged_attn_launches": c.launches}
    log("hymba card vs cpu:", json.dumps(line))
    return c.launches


def load_hymba():
    """hymba-1.5b at every published width and all 32 layers, random bf16
    weights (the SSM's A_log, D, dt_bias and the fusion's mix_beta float32)
    from a seeded generator on the card, and eight 1536-token prompts."""
    from repro_torch.models import lm, registry
    from repro_torch.nn.module import count_params, materialize

    cfg = registry.get_config(HYMBA_ARCH)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = materialize(lm.param_spec(cfg), gen, "cuda")
    torch.cuda.synchronize()
    n = count_params(lm.param_spec(cfg))
    log(f"{HYMBA_ARCH}: {n / 1e9:.3f} B params ({2 * n / 1e9:.2f} GB in bf16), all "
        f"{cfg.n_layers} layers, materialized on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = list(rng.integers(0, cfg.vocab, size=(HYMBA_PROMPTS, 1536), dtype=np.int32))
    return cfg, params, prompts


HYMBA_PROMPTS, HYMBA_COMPARED = 8, 2


def ssm_prefill_cost(cfg, params):
    """Wall time of one layer's ``ssm_block`` over a 256-token prefill chunk
    on the card (one slot, bf16, from a zero state), and the device
    operations it launches: the per-token scan's host cost."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.nn.ssm import init_ssm_state, ssm_block
    from repro_torch.tree import tree_map
    p = tree_map(lambda a: a[0], params["segments"][1]["ssm"])
    b = cfg.blocks[1]
    x = (torch.randn((1, 256, cfg.d_model), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(3)) * 0.5
         ).to(torch.bfloat16)
    state = init_ssm_state(b.ssm, cfg.d_model, 1, device="cuda")
    ssm_block(p, x, b.ssm, state=state)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(3):
        ssm_block(p, x, b.ssm, state=state)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) / 3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ssm_block(p, x, b.ssm, state=state)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = sum(getattr(e, "self_device_time_total", None)
                 or getattr(e, "self_cuda_time_total", 0) for e in kernels)
    ops = sum(e.count for e in kernels)
    return {"ssm_block_wall_ms_per_layer_chunk": wall * 1e3,
            "ssm_block_device_ms_per_layer_chunk": dev_us / 1e3,
            "ssm_block_device_ops_per_layer_chunk": ops,
            "ssm_device_ops_per_token_per_layer": ops / 256,
            "ssm_wall_ms_per_chunk_all_layers": wall * 1e3 * cfg.n_layers}


def serve_hybrid(cfg, params, prompts):
    """hymba-1.5b served at full width and full depth through the port's
    engine on the card: 8 prompts of 1536 tokens (past the 1024-token window,
    so the rings of 1024 + 256 rows wrap) with 64 greedy tokens, max_len 2048,
    block 16, chunk 256 (mixed dispatch and prefix sharing off by themselves).
    The three global layers run on the paged pool and launch
    ``paged_attention`` once each a decode-carrying forward (G = 5, D = 64);
    the window layers' rings and the SSM run plain PyTorch on the card.  The
    first ``HYMBA_COMPARED`` streams are held against the same prompts
    served with ``paged=False`` (the global layers on dense caches and plain
    sdpa, no launch), under swap pressure (a pool of 194 blocks, which
    admits 2 prompts of 97 blocks and then cannot grow them, with a
    320-block swap tier) and at horizon 4, a parting accepted only at a
    reported near tie (fewer prompts than the base run: the prefill's
    per-token SSM scan makes each run host-bound).  Then a decode profile
    (device busy share, the SSM's and ``paged_attn``'s shares) and the
    per-token cost of the SSM scan at prefill.  Returns each run's launches."""
    from repro_torch.nn import blocks

    a = serve(cfg, params, prompts, 64, max_len=2048, timed=True)
    s1 = a["summary"]
    chunk_ms = [t * 1e3 for t in a["times"]["_prefill"]]
    line = {"arch": HYMBA_ARCH, "layers": cfg.n_layers, "requests": len(prompts),
            "prompt": 1536, "generated": 64, "wall_s": a["wall"],
            "decode_tokens_per_s": s1["decode_tokens_per_s"], "ttft_s": s1["ttft_s"],
            "tpot_s": s1["tpot_s"], "prefill_time_s": s1["prefill_time_s"],
            "prefill_tokens": s1["prefill_tokens"],
            "prefill_chunk_wall_ms_median": float(np.median(chunk_ms)),
            "mixed_dispatches": s1["mixed"]["dispatches"],
            "decode_dispatches": s1["decode_dispatches"],
            "forwards_through_kernel": a["forwards"], "paged_attn_launches": a["launches"],
            "launches_per_forward": a["launches"] / a["forwards"],
            "peak_memory_gb": a["peak"] / 1e9, "kv_cache_bytes": s1["kv_cache_bytes"]}
    log("hybrid serving:", json.dumps(line))
    few = prompts[:HYMBA_COMPARED]
    base = {rid: a["streams"][rid] for rid in range(HYMBA_COMPARED)}
    runs = {"dense": serve(cfg, params, few, 64, max_len=2048, paged=False),
            "swap": serve(cfg, params, few, 64, max_len=2048, n_blocks=194,
                          swap_blocks=320),
            "h4": serve(cfg, params, few, 64, max_len=2048, horizon=4)}
    if runs["swap"]["summary"]["preemptions"]["swap"] <= 0:
        raise AssertionError(f"hybrid swap run: no swap preemption "
                             f"{runs['swap']['summary']['preemptions']}")
    h4 = runs["h4"]["summary"]
    if h4["decode_dispatches"] >= h4["decode_steps"]:
        raise AssertionError("hybrid horizon 4: no dispatch ran more than one decode step")
    for what, r in runs.items():
        s = r["summary"]
        n_equal = compare_streams(params, cfg, prompts, base, r["streams"],
                                  f"hybrid {what} vs the default run")
        log(f"hybrid serving ({what}):", json.dumps({
            "wall_s": r["wall"], "streams_equal_to_default": n_equal,
            "decode_tokens_per_s": s["decode_tokens_per_s"], "ttft_s": s["ttft_s"],
            "preemptions": s["preemptions"], "decode_dispatches": s["decode_dispatches"],
            "decode_steps": s["decode_steps"], "kv_cache_bytes": s["kv_cache_bytes"],
            "forwards": r["forwards"], "paged_attn_launches": r["launches"],
            "peak_memory_gb": r["peak"] / 1e9}))
    with ranged(blocks, "ssm_block"):
        profile_decode(params, cfg, prompts, max_len=2048,
                       label="hybrid decode profile (8 slots, 4 steps each block)",
                       op_shares={"ssm": lambda e: e.key == "ssm_block"})
    cost = ssm_prefill_cost(cfg, params)
    cost["prefill_chunk_wall_ms_median"] = line["prefill_chunk_wall_ms_median"]
    cost["ssm_share_of_prefill_chunk"] = (cost["ssm_wall_ms_per_chunk_all_layers"]
                                          / line["prefill_chunk_wall_ms_median"])
    log("hybrid prefill, the SSM scan's cost:", json.dumps(cost))
    return {"serve_hybrid": a["launches"], "serve_hybrid_dense": runs["dense"]["launches"],
            "serve_hybrid_swap": runs["swap"]["launches"],
            "serve_hybrid_h4": runs["h4"]["launches"]}


# ---------------------------------------------------------------------------
# xLSTM (xlstm-350m) and the dense GQA configs (nemotron-4-15b)
# ---------------------------------------------------------------------------

XLSTM_ARCH, NEMOTRON_ARCH = "xlstm-350m", "nemotron-4-15b"
XLSTM_PROMPT, XLSTM_GEN, XLSTM_MAX_LEN = 2048, 64, 4096
XLSTM_LONG_PROMPT, XLSTM_LONG_GEN = 16_384, 32
# |card - CPU| bound on xlstm_card's float32 logits: 2.9x the worst measured
# on an H100 80GB HBM3 at 700 W, 1.37e-4 in the padded 600-token prefill (PERF.md §6)
XLSTM_CARD_TOL = 4e-4
# prompts of the base run that the horizon-4 and swap-pressure runs serve
XLSTM_COMPARED = 2


def xlstm_card_vs_cpu():
    """xlstm-350m at every published width (d_model 1024, 4 heads of 256,
    vocab 50,304) over 1 mLSTM and 1 sLSTM layer, float32 weights from a
    seeded generator on the host and their copy on the card: the logits of a
    one-shot prefill of 2 slots x 600 tokens (past the 512-token chunk, so
    the chunkwise form runs a padded second chunk) and of 3 decode steps
    (the token scans) on serving caches agree within ``XLSTM_CARD_TOL``.
    Zeroing the sLSTM's ``out`` projection on the card must move the logits
    past that bound (the check sees the sLSTM).  No ``paged_attention``
    launch.  Returns the card run's launches (0)."""
    import dataclasses

    from repro_torch.kernels.paged_attn import paged_attention
    from repro_torch.launch.steps import init_serving_caches
    from repro_torch.models import lm, registry
    from repro_torch.nn.module import count_params, materialize
    from repro_torch.tree import tree_map

    full = registry.get_config(XLSTM_ARCH)
    mlstm, slstm = full.blocks[0], full.blocks[1]
    cfg = full.with_overrides(kv_dtype="float32", blocks=(
        dataclasses.replace(mlstm, n_layers=1), dataclasses.replace(slstm, n_layers=1)))
    spec = tree_map(lambda s: dataclasses.replace(s, dtype=torch.float32),
                    lm.param_spec(cfg))
    t0 = time.perf_counter()
    host = materialize(spec, torch.Generator().manual_seed(0), "cpu")
    card = tree_map(lambda t: t.cuda(), host)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(21)
    B, S, steps = 2, 600, 3
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, size=(B, S), dtype=np.int32))
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(steps, B, 1), dtype=np.int32))

    def logits(p, dev):
        caches = init_serving_caches(cfg, B, 1024, device=dev)
        out, caches, _ = lm.forward(p, prompt.to(dev), cfg, caches=caches)
        outs = [out]
        for i in range(steps):
            start = torch.full((B, 1), S + i, dtype=torch.int32, device=dev)
            out, caches, _ = lm.forward(p, toks[i].to(dev), cfg, caches=caches,
                                        start_pos=start)
            outs.append(out)
        return torch.cat(outs, dim=1).cpu()              # [B, S + steps, V]

    paged_attention.launches = 0
    t = time.perf_counter()
    on_card = logits(card, "cuda")
    card_s = time.perf_counter() - t
    launches = paged_attention.launches
    t = time.perf_counter()
    on_cpu = logits(host, "cpu")
    cpu_s = time.perf_counter() - t
    if launches:
        raise AssertionError(f"xlstm card check: paged_attention launched {launches}x")
    if not bool(torch.isfinite(on_card).all()):
        raise AssertionError("xlstm card check: non-finite logits on the card")
    err = (on_card - on_cpu).abs()
    by_part = {"prefill": err[:, :S].max().item(), "decode": err[:, S:].max().item()}
    if err.max().item() > XLSTM_CARD_TOL:
        raise AssertionError(f"xlstm card check: card logits off the CPU's by "
                             f"{err.max():.3e} > {XLSTM_CARD_TOL} ({by_part})")
    card["segments"][1]["cell"]["out"].zero_()
    moved = (logits(card, "cuda") - on_card).abs()
    seen = (moved > XLSTM_CARD_TOL).float().mean().item()
    if seen < 0.5:
        raise AssertionError(f"xlstm card check: zeroing the sLSTM's out projection moves "
                             f"{seen:.1%} of the logits past the bound")
    log("xlstm card vs cpu:", json.dumps({
        "arch": XLSTM_ARCH, "layers": "1 mLSTM + 1 sLSTM of 24", "dtype": "float32",
        "params_m": count_params(spec) / 1e6, "slots": B, "prefill": S, "chunk": 512,
        "decode_steps": steps, "logits_max_abs_err": err.max().item(),
        "logits_max_abs_err_by_part": by_part, "bound": XLSTM_CARD_TOL,
        "logits_max_abs": on_cpu.abs().max().item(),
        "slstm_out_zeroed_max_move": moved.max().item(),
        "slstm_out_zeroed_share_past_bound": seen, "setup_s": setup_s, "card_s": card_s,
        "cpu_s": cpu_s, "paged_attn_launches": launches}))
    return launches


def load_xlstm():
    """xlstm-350m at every published width and all 24 layers (3 x (7 mLSTM
    + 1 sLSTM)), random bf16 weights (``r_zifo`` and the norms float32)
    from a seeded generator on the card, and the static loop's 8 prompts of
    2048 tokens."""
    from repro_torch.launch.serve import _batch_requests
    from repro_torch.models import lm, registry
    from repro_torch.nn.module import count_params, materialize

    cfg = registry.get_config(XLSTM_ARCH)
    t0 = time.perf_counter()
    params = materialize(lm.param_spec(cfg), torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    torch.cuda.synchronize()
    n = count_params(lm.param_spec(cfg))
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"{XLSTM_ARCH}: {n:,} params ({nbytes / 1e9:.3f} GB), all {cfg.n_layers} layers, "
        f"materialized on the card in {time.perf_counter() - t0:.1f} s")
    prompts = [r.prompt for r in _batch_requests(cfg, 8, XLSTM_PROMPT, XLSTM_GEN, 0)]
    return cfg, params, prompts


def _leaves(tree):
    from repro_torch.tree import leaves_with_path
    return [t for _, _, t in leaves_with_path(tree)]


def _state_bytes_a_slot(cfg):
    """Bytes of one slot's decode state (the cells' float32 state)."""
    from repro_torch.launch.steps import init_serving_caches
    return sum(t.numel() * t.element_size()
               for t in _leaves(init_serving_caches(cfg, 1, 16, device="meta")))


def serve_xlstm(cfg, params, prompts):
    """xlstm-350m served through the port's engine on the card at full width
    and depth: 8 prompts of 2048 tokens + 64 greedy tokens, 8 slots,
    max_len 4096, chunk 256 (the chunkwise form at a chunk of 256 for each
    prefill chunk, the token scans at decode), the engine's defaults (no
    pool: mixed dispatch, prefix sharing and speculation off).  Held against
    it, a parting accepted only at a reported near tie: on its first
    ``XLSTM_COMPARED`` prompts (the prefill's per-token sLSTM scans make
    each run host-bound), horizon 4 and swap pressure (a logical pool of
    258 blocks, which admits both prompts of 129 blocks and cannot grow
    them, and a swap tier of 258: the cell state rides the swap ticket).
    The static loop (``serve_static``, whose one-shot prefill runs the
    chunkwise form at a chunk of 512 against the engine's 256) serves the
    8 prompts in bf16 for its tok/s and peak memory; in bf16 the two
    orders round apart and these random weights' logits hold three-way
    near ties (on an H100, a parting at step 0 between the reference's
    first and third token, 0.11 apart), which the near-tie rule cannot
    hold.  So its streams are held against the engine's in float32 (the
    same weights, upcast) on the first ``XLSTM_COMPARED`` prompts.  Then
    one prompt of 16,384 tokens + 32 (max_len 16,448), whose state and peak
    memory do not grow with its context; a decode profile with the mLSTM's
    and sLSTM's shares (``record_function`` ranges; prompts of 256 tokens,
    as a step's work does not depend on the context).  Every run launches
    ``paged_attention`` 0 times (:class:`counting`).  Returns each run's
    launches."""
    from repro_torch.kernels.paged_attn import paged_attention
    from repro_torch.launch.serve import serve_static
    from repro_torch.nn import blocks
    from repro_torch.tree import tree_map

    state = _state_bytes_a_slot(cfg)
    a = serve(cfg, params, prompts, XLSTM_GEN, max_len=XLSTM_MAX_LEN, timed=True)
    s1 = a["summary"]
    chunk_ms = [t * 1e3 for t in a["times"]["_prefill"]]
    base = {"arch": XLSTM_ARCH, "layers": cfg.n_layers, "requests": len(prompts),
            "prompt": XLSTM_PROMPT, "generated": XLSTM_GEN, "wall_s": a["wall"],
            "decode_tokens_per_s": s1["decode_tokens_per_s"], "ttft_s": s1["ttft_s"],
            "tpot_s": s1["tpot_s"], "prefill_time_s": s1["prefill_time_s"],
            "prefill_tokens": s1["prefill_tokens"],
            "prefill_ms_per_prompt_token": s1["prefill_time_s"] * 1e3 / s1["prefill_tokens"],
            "prefill_chunk_wall_ms_median": float(np.median(chunk_ms)),
            "decode_dispatches": s1["decode_dispatches"], "forwards": a["forwards"],
            "paged_attn_launches": a["launches"], "peak_memory_gb": a["peak"] / 1e9,
            "state_bytes_a_slot": state, "kv_cache_bytes": s1["kv_cache_bytes"]}
    log("xlstm serving:", json.dumps(base))
    few = prompts[:XLSTM_COMPARED]
    runs = {"h4": serve(cfg, params, few, XLSTM_GEN, max_len=XLSTM_MAX_LEN, horizon=4),
            "swap": serve(cfg, params, few, XLSTM_GEN, max_len=XLSTM_MAX_LEN,
                          n_blocks=258, swap_blocks=258)}
    if runs["swap"]["summary"]["preemptions"]["swap"] <= 0:
        raise AssertionError(f"xlstm swap run: no swap preemption "
                             f"{runs['swap']['summary']['preemptions']}")
    h4 = runs["h4"]["summary"]
    if h4["decode_dispatches"] >= h4["decode_steps"]:
        raise AssertionError("xlstm horizon 4: no dispatch ran more than one decode step")
    for what, r in runs.items():
        s = r["summary"]
        base_few = {rid: a["streams"][rid] for rid in range(XLSTM_COMPARED)}
        n_equal = compare_streams(params, cfg, prompts, base_few, r["streams"],
                                  f"xlstm {what} vs the default run")
        log(f"xlstm serving ({what}):", json.dumps({
            "wall_s": r["wall"], "streams_equal_to_default": n_equal,
            "decode_tokens_per_s": s["decode_tokens_per_s"], "ttft_s": s["ttft_s"],
            "preemptions": s["preemptions"], "decode_dispatches": s["decode_dispatches"],
            "decode_steps": s["decode_steps"], "paged_attn_launches": r["launches"],
            "peak_memory_gb": r["peak"] / 1e9}))

    def static_loop(p, batch):
        paged_attention.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        generated, tps = serve_static(cfg, batch=batch, prompt_len=XLSTM_PROMPT,
                                      gen=XLSTM_GEN, seed=0, params=p, verbose=False)
        line = {"wall_s": time.perf_counter() - t, "decode_tokens_per_s": tps,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                "paged_attn_launches": paged_attention.launches}
        if line["paged_attn_launches"]:
            raise AssertionError(f"the static loop launched paged_attention: {line}")
        if not ((generated >= 0) & (generated < cfg.vocab)).all():
            raise AssertionError("serve_static: token out of range")
        return {i: [int(x) for x in row] for i, row in enumerate(generated)}, line

    static, line = static_loop(params, len(prompts))
    line["bf16_streams_equal_to_engine"] = sum(static[i] == a["streams"][i] for i in static)
    line["bf16_first_parting_steps"] = [
        next((j for j, (x, y) in enumerate(zip(static[i], a["streams"][i])) if x != y), None)
        for i in static]
    p32 = tree_map(lambda t: t.float(), params)
    e32 = serve(cfg, p32, few, XLSTM_GEN, max_len=XLSTM_MAX_LEN)
    static32, line32 = static_loop(p32, XLSTM_COMPARED)
    line["float32_streams_equal_to_engine"] = compare_streams(
        p32, cfg, prompts, e32["streams"], static32,
        "xlstm float32 serve_static vs the float32 engine")
    line.update(float32_engine_wall_s=e32["wall"], float32_static_wall_s=line32["wall_s"],
                float32_paged_attn_launches=e32["launches"] + line32["paged_attn_launches"])
    del p32
    log("xlstm static loop:", json.dumps(line))

    long_prompt = np.random.default_rng(5).integers(0, cfg.vocab, size=XLSTM_LONG_PROMPT,
                                                    dtype=np.int32)
    lc = serve(cfg, params, [long_prompt], XLSTM_LONG_GEN, slots=1,
               max_len=XLSTM_LONG_PROMPT + 64)
    s = lc["summary"]
    log("xlstm long context:", json.dumps({
        "prompt": XLSTM_LONG_PROMPT, "generated": XLSTM_LONG_GEN, "wall_s": lc["wall"],
        "prefill_ms_per_prompt_token": s["prefill_time_s"] * 1e3 / s["prefill_tokens"],
        "base_prefill_ms_per_prompt_token": base["prefill_ms_per_prompt_token"],
        "ttft_s": s["ttft_s"], "decode_tokens_per_s": s["decode_tokens_per_s"],
        "peak_memory_gb": lc["peak"] / 1e9, "base_peak_memory_gb": base["peak_memory_gb"],
        "state_bytes_a_slot": state, "paged_attn_launches": lc["launches"]}))

    with ranged(blocks, "mlstm_block"), ranged(blocks, "slstm_block"):
        profile_decode(params, cfg, [p[:256] for p in prompts],
                       label="xlstm decode profile (8 slots, 4 steps each block)",
                       op_shares={"mlstm": lambda e: e.key == "mlstm_block",
                                  "slstm": lambda e: e.key == "slstm_block"})
    return {"serve_xlstm": a["launches"], "serve_xlstm_h4": runs["h4"]["launches"],
            "serve_xlstm_swap": runs["swap"]["launches"],
            "serve_xlstm_static": line["paged_attn_launches"],
            "serve_xlstm_float32": line["float32_paged_attn_launches"],
            "serve_xlstm_long": lc["launches"]}


def load_nemotron():
    """nemotron-4-15b at every published width and all 32 layers (d_model
    6144, 48 query heads over 8 KV heads of 128, relu² MLP of 24,576, vocab
    256,000), random bf16 weights from a seeded generator on the card, and
    eight 512-token prompts."""
    from repro_torch.models import lm, registry
    from repro_torch.nn.module import count_params, materialize

    cfg = registry.get_config(NEMOTRON_ARCH)
    t0 = time.perf_counter()
    params = materialize(lm.param_spec(cfg), torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    torch.cuda.synchronize()
    n = count_params(lm.param_spec(cfg))
    log(f"{NEMOTRON_ARCH}: {n / 1e9:.3f} B params ({2 * n / 1e9:.1f} GB in bf16), all "
        f"{cfg.n_layers} layers, materialized on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = list(rng.integers(0, cfg.vocab, size=(8, 512), dtype=np.int32))
    return cfg, params, prompts


def serve_nemotron(cfg, params, prompts):
    """nemotron-4-15b served at full width and depth with the engine's
    defaults (mixed dispatch and prefix sharing on: the model is fully
    paged): 8 prompts of 512 tokens + 32 greedy tokens; every
    decode-carrying forward launches ``paged_attention`` once a layer (32 a
    forward, G = 6, :class:`counting`).  Then a decode profile with
    ``paged_attn``'s share.  Returns the run's launches."""
    a = serve(cfg, params, prompts, 32)
    s1 = a["summary"]
    log("nemotron serving:", json.dumps({
        "arch": NEMOTRON_ARCH, "layers": cfg.n_layers, "requests": len(prompts),
        "prompt": 512, "generated": 32, "wall_s": a["wall"],
        "decode_tokens_per_s": s1["decode_tokens_per_s"], "ttft_s": s1["ttft_s"],
        "tpot_s": s1["tpot_s"], "prefill_time_s": s1["prefill_time_s"],
        "mixed_dispatches": s1["mixed"]["dispatches"],
        "decode_dispatches": s1["decode_dispatches"],
        "forwards_through_kernel": a["forwards"], "paged_attn_launches": a["launches"],
        "launches_per_forward": a["launches"] / a["forwards"],
        "peak_memory_gb": a["peak"] / 1e9, "kv_cache_bytes": s1["kv_cache_bytes"]}))
    if a["launches"] != cfg.n_layers * a["forwards"] or not a["forwards"]:
        raise AssertionError(f"nemotron: {a['launches']} launches over {a['forwards']} "
                             f"forwards, not {cfg.n_layers} a forward")
    profile_decode(params, cfg, prompts,
                   label="nemotron decode profile (8 slots, 4 steps each block)")
    return {"serve_nemotron": a["launches"]}


# ---------------------------------------------------------------------------
# phases 13-14: MusicGen's codebook frames, Qwen2-VL's M-RoPE and extras
# ---------------------------------------------------------------------------

MUSICGEN_ARCH, VLM_ARCH = "musicgen-medium", "qwen2-vl-2b"
# |card - CPU| bounds of the 2-layer float32 logits (TF32 off), at most 4x
# the worst measured on an H100: 2.26e-6 and 1.19e-5 (PERF.md §6)
MUSICGEN_CARD_TOL = 9e-6
VLM_CARD_TOL = 4.5e-5
# prompts of a base serving run that its comparison runs serve
SERVE_COMPARED = 2
VLM_PROMPT, VLM_TEXT_PROMPT, SERVE_GEN = 448, 512, 32


def _two_layers(arch):
    """An arch's published widths over 2 of its layers, float32 KV."""
    import dataclasses

    from repro_torch.models import registry
    full = registry.get_config(arch)
    return full.with_overrides(kv_dtype="float32", blocks=(
        dataclasses.replace(full.blocks[0], n_layers=2),))


def _float32_weights(cfg):
    """float32 weights from a seeded generator on the card, and their copy on
    the host."""
    import dataclasses

    from repro_torch.models import lm
    from repro_torch.nn.module import materialize
    from repro_torch.tree import tree_map
    spec = tree_map(lambda s: dataclasses.replace(s, dtype=torch.float32),
                    lm.param_spec(cfg))
    card = materialize(spec, torch.Generator(device="cuda").manual_seed(0), "cuda")
    return card, tree_map(lambda t: t.cpu(), card)


def _paged_logits(cfg, p, dev, prompt, steps, extras=None):
    """Logits of a prefill of ``prompt`` ([B, S] or [B, K, S]) and of one
    decode forward a token of ``steps`` ([n, B, 1] or [n, B, K, 1]) on paged
    serving caches: [B, S + n, ...] on the host.  ``extras`` (patch_embeds,
    pos3d) go to the prefill; decode steps take (t, t, t)."""
    from repro_torch.launch.steps import init_serving_caches
    from repro_torch.models import lm
    B, S = prompt.shape[0], prompt.shape[-1]
    pages = -(-(S + len(steps)) // 16)
    tables = torch.arange(B * pages, dtype=torch.int32, device=dev).reshape(B, pages)
    caches = init_serving_caches(cfg, B, pages * 16, block_size=16, n_blocks=B * pages,
                                 device=dev)
    kw = {} if extras is None else {k: torch.as_tensor(v, device=dev)
                                    for k, v in extras.items()}
    with torch.no_grad():
        out, caches, _ = lm.forward(p, prompt.to(dev), cfg, caches=caches, tables=tables,
                                    **kw)
        outs = [out]
        for i, tok in enumerate(steps):
            start = torch.full((B, 1), S + i, dtype=torch.int32, device=dev)
            out, caches, _ = lm.forward(p, tok.to(dev), cfg, caches=caches,
                                        start_pos=start, tables=tables)
            outs.append(out)
    return torch.cat(outs, dim=1).cpu()


def _card_vs_cpu(name, cfg, card, host, prompt, steps, tol, wrong, extras=None,
                 reqs=None):
    """The logits of :func:`_paged_logits` on the card (``paged_attn`` once a
    layer a decode step) and on the CPU (plain path) agree within ``tol``;
    each of ``wrong`` (what → (params, cfg) on the card) moves most logits
    past it; with ``reqs`` (a request factory), the engine's greedy streams
    on the card equal the CPU's.  Returns the report."""
    from repro_torch.kernels.paged_attn import paged_attention
    from repro_torch.serving import ServingEngine
    paged_attention.launches = 0
    t = time.perf_counter()
    on_card = _paged_logits(cfg, card, "cuda", prompt, steps, extras)
    card_s = time.perf_counter() - t
    launches = paged_attention.launches
    t = time.perf_counter()
    on_cpu = _paged_logits(cfg, host, "cpu", prompt, steps, extras)
    cpu_s = time.perf_counter() - t
    if launches != cfg.n_layers * len(steps):
        raise AssertionError(f"{name}: {launches} paged_attention launches, not "
                             f"{cfg.n_layers} layers x {len(steps)} decode steps")
    if not bool(torch.isfinite(on_card).all()):
        raise AssertionError(f"{name}: non-finite logits on the card")
    err = (on_card - on_cpu).abs()
    S = prompt.shape[-1]
    by_part = {"prefill": err[:, :S].max().item(), "decode": err[:, S:].max().item()}
    line = {"layers": f"2 of {name}", "dtype": "float32", "slots": prompt.shape[0],
            "prefill": S, "decode_steps": len(steps), "logits_max_abs_err": err.max().item(),
            "logits_max_abs_err_by_part": by_part, "bound": tol,
            "logits_max_abs": on_cpu.abs().max().item(), "card_s": card_s, "cpu_s": cpu_s,
            "paged_attn_launches": launches}
    if err.max().item() > tol:
        raise AssertionError(f"{name}: card logits off the CPU's by {err.max():.3e} > "
                             f"{tol} ({by_part})")
    for what, (p, c) in wrong.items():
        moved = (_paged_logits(c, p, "cuda", prompt, steps, extras) - on_card).abs()
        line[f"{what}_max_move"] = moved.max().item()
        line[f"{what}_share_past_bound"] = seen = (moved > tol).float().mean().item()
        if seen < 0.5:
            raise AssertionError(f"{name}: {what} moves {seen:.1%} of the logits past "
                                 f"the bound; the check cannot see it")
    if reqs is not None:
        streams = {}
        for dev, p in (("cuda", card), ("cpu", host)):
            eng = ServingEngine(cfg, slots=3, max_len=64, block_size=16, params=p,
                                device=dev, prefill_chunk=64)
            rs = reqs()
            eng.run(rs)
            streams[dev] = check_streams(rs, rs[0].max_new, cfg.vocab)
        if streams["cpu"] != streams["cuda"]:
            raise AssertionError(f"{name}: card streams {streams['cuda']} != cpu "
                                 f"{streams['cpu']}")
        line["engine_streams_equal"] = len(streams["cuda"])
    return line


def musicgen_card_vs_cpu():
    """musicgen-medium at every published width (d_model 1536, 24 heads over
    24 KV heads of 64, d_ff 6144, 4 codebooks of 2048) over 2 of its 48
    layers, float32 weights on the card and their copy on the host: the
    logits ``[B, S, 4, V]`` of a prefill of 2 x 40 frames and of 3 decode
    frames on paged serving caches (``paged_attn`` at G = 1, D = 64 on the
    card) agree within ``MUSICGEN_CARD_TOL``, and so do the engine's
    greedy frame streams.  A wrong codebook axis, the head's or the
    embedding's codebooks rolled by one, moves most logits past the bound.
    Returns the card run's launches."""
    from repro_torch.serving import Request
    cfg = _two_layers(MUSICGEN_ARCH)
    K = cfg.n_codebooks
    t0 = time.perf_counter()
    card, host = _float32_weights(cfg)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(31)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, size=(2, K, 40), dtype=np.int32))
    steps = torch.as_tensor(rng.integers(0, cfg.vocab, size=(3, 2, K, 1), dtype=np.int32))
    wrong = {"head_codebooks_rolled": (dict(card, lm_head=card["lm_head"].roll(1, 0)), cfg),
             "embed_codebooks_rolled": (dict(card, embed=card["embed"].roll(1, 0)), cfg)}
    reqs_prompts = rng.integers(0, cfg.vocab, size=(3, K, 24), dtype=np.int32)

    def reqs():
        return [Request(rid=i, prompt=pr, max_new=8) for i, pr in enumerate(reqs_prompts)]

    line = _card_vs_cpu(MUSICGEN_ARCH, cfg, card, host, prompt, steps, MUSICGEN_CARD_TOL,
                        wrong, reqs=reqs)
    line.update(codebooks=K, setup_s=setup_s)
    log("musicgen card vs cpu:", json.dumps(line))
    return line["paged_attn_launches"]


def vlm_card_vs_cpu():
    """qwen2-vl-2b at every published width (d_model 1536, 12 query heads
    over 2 KV heads of 128, M-RoPE sections (16, 24, 24), d_ff 8960, vocab
    151,936) over 2 of its 28 layers, float32 weights on the card and their
    copy on the host: the logits of a prefill of 2 x 48 tokens with the
    vision stub's extras (9 patches on a 3 x 3 grid) and of 3 decode steps
    at (t, t, t) on paged serving caches (``paged_attn`` at G = 6 over 2 KV
    heads on the card) agree within ``VLM_CARD_TOL``, and so do the
    engine's greedy streams of 3 requests with extras.  Wrong M-RoPE
    sections (reversed: (24, 24, 16)) or no 3-D ids (RoPE at (t, t, t))
    move most logits past the bound.  Returns the card run's launches."""
    import dataclasses

    from repro_torch.data import vlm_stub_extras
    from repro_torch.serving import Request
    cfg = _two_layers(VLM_ARCH)
    t0 = time.perf_counter()
    card, host = _float32_weights(cfg)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(32)
    S = 48
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, size=(2, S), dtype=np.int32))
    steps = torch.as_tensor(rng.integers(0, cfg.vocab, size=(3, 2, 1), dtype=np.int32))
    extras = vlm_stub_extras(32, batch=2, seq=S, d_model=cfg.d_model, n_patches=S // 4)
    attn = cfg.blocks[0].attn
    reversed_sections = tuple(reversed(attn.mrope_sections))
    sections = cfg.with_overrides(blocks=(dataclasses.replace(
        cfg.blocks[0], attn=dataclasses.replace(attn, mrope_sections=reversed_sections)),))
    rope = cfg.with_overrides(blocks=(dataclasses.replace(
        cfg.blocks[0], attn=dataclasses.replace(attn, rope="rope")),))
    wrong = {"sections_reversed": (card, sections), "rope_at_t_t_t": (card, rope)}
    req_prompts = rng.integers(0, cfg.vocab, size=(3, 24), dtype=np.int32)
    req_extras = vlm_stub_extras(33, batch=3, seq=24, d_model=cfg.d_model, n_patches=6)

    def reqs():
        return [Request(rid=i, prompt=pr, max_new=8,
                        extras={k: v[i] for k, v in req_extras.items()})
                for i, pr in enumerate(req_prompts)]

    line = _card_vs_cpu(VLM_ARCH, cfg, card, host, prompt, steps, VLM_CARD_TOL, wrong,
                        extras=extras, reqs=reqs)
    line.update(patches=int(extras["patch_embeds"].shape[1]), sections=attn.mrope_sections,
                setup_s=setup_s)
    log("vlm card vs cpu:", json.dumps(line))
    return line["paged_attn_launches"]


def _load(arch):
    """An arch at every published width and depth, random bf16 weights from a
    seeded generator on the card."""
    from repro_torch.models import lm, registry
    from repro_torch.nn.module import count_params, materialize
    cfg = registry.get_config(arch)
    t0 = time.perf_counter()
    params = materialize(lm.param_spec(cfg), torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    torch.cuda.synchronize()
    n = count_params(lm.param_spec(cfg))
    log(f"{arch}: {n:,} params ({2 * n / 1e9:.2f} GB in bf16), all {cfg.n_layers} "
        f"layers, materialized on the card in {time.perf_counter() - t0:.1f} s")
    return cfg, params


def _serving_line(arch, r, **extra):
    s = r["summary"]
    return {"arch": arch, "wall_s": r["wall"],
            "decode_tokens_per_s": s["decode_tokens_per_s"], "ttft_s": s["ttft_s"],
            "tpot_s": s["tpot_s"], "prefill_time_s": s["prefill_time_s"],
            "mixed_dispatches": s["mixed"]["dispatches"],
            "decode_dispatches": s["decode_dispatches"], "decode_steps": s["decode_steps"],
            "preemptions": s["preemptions"], "forwards_through_kernel": r["forwards"],
            "paged_attn_launches": r["launches"],
            "launches_per_forward": r["launches"] / max(1, r["forwards"]),
            "peak_memory_gb": r["peak"] / 1e9, "kv_cache_bytes": s["kv_cache_bytes"],
            **extra}


def _static_vs_engine(cfg, params, prompts, base, what, extras=None):
    """``serve_static`` on the first ``SERVE_COMPARED`` prompts of
    ``_batch_requests`` (those the engine served) against the engine's
    streams, partings at reported near ties.  Returns its line."""
    from repro_torch.kernels.paged_attn import paged_attention
    from repro_torch.launch.serve import serve_static
    paged_attention.launches = 0
    t = time.perf_counter()
    generated, tps = serve_static(cfg, batch=SERVE_COMPARED, prompt_len=prompts[0].shape[-1],
                                  gen=SERVE_GEN, seed=0, params=params, verbose=False)
    wall = time.perf_counter() - t
    if paged_attention.launches:
        raise AssertionError(f"{what}: the static loop launched paged_attention")
    static = {i: [_token(g[..., j]) for j in range(SERVE_GEN)]
              for i, g in enumerate(generated)}
    n_equal = compare_streams(params, cfg, prompts, {i: base[i] for i in static}, static,
                              what, extras=extras)
    return {"wall_s": wall, "decode_tokens_per_s": tps, "streams_equal_to_engine": n_equal}


def serve_musicgen():
    """musicgen-medium served at every published width and all 48 layers
    (random bf16 weights): 8 prompts of [4, 512] EnCodec tokens (the static
    loop's, ``_batch_requests``) + 32 greedy frames with the engine's
    defaults (mixed dispatch and prefix sharing on), every decode-carrying
    forward launching ``paged_attention`` at G = 1, D = 64 once a layer
    (:class:`counting`); on its first 2 prompts, horizon 4 and swap
    pressure (66 blocks admit both prompts and cannot grow them; a swap
    tier of 66) and the static loop, each held against the base run frame
    by frame, partings only at reported near ties of a codebook's head;
    then a decode profile with ``paged_attn``'s share.  Returns each run's
    launches."""
    from repro_torch.launch.serve import _batch_requests
    cfg, params = _load(MUSICGEN_ARCH)
    prompts = [r.prompt for r in _batch_requests(cfg, 8, 512, SERVE_GEN, 0)]
    a = serve(cfg, params, prompts, SERVE_GEN)
    log("musicgen serving:", json.dumps(_serving_line(
        MUSICGEN_ARCH, a, layers=cfg.n_layers, codebooks=cfg.n_codebooks,
        requests=len(prompts), prompt=list(prompts[0].shape), generated=SERVE_GEN)))
    few = prompts[:SERVE_COMPARED]
    runs = {"h4": serve(cfg, params, few, SERVE_GEN, horizon=4),
            "swap": serve(cfg, params, few, SERVE_GEN, n_blocks=66, swap_blocks=66)}
    if runs["swap"]["summary"]["preemptions"]["swap"] <= 0:
        raise AssertionError(f"musicgen swap run: no swap preemption "
                             f"{runs['swap']['summary']['preemptions']}")
    h4 = runs["h4"]["summary"]
    if h4["decode_dispatches"] >= h4["decode_steps"]:
        raise AssertionError("musicgen horizon 4: no dispatch ran more than one decode step")
    base = {rid: a["streams"][rid] for rid in range(SERVE_COMPARED)}
    for what, r in runs.items():
        n_equal = compare_streams(params, cfg, prompts, base, r["streams"],
                                  f"musicgen {what} vs the default run")
        log(f"musicgen serving ({what}):", json.dumps(_serving_line(
            MUSICGEN_ARCH, r, streams_equal_to_default=n_equal)))
    log("musicgen static loop:", json.dumps(_static_vs_engine(
        cfg, params, prompts, a["streams"], "musicgen serve_static vs the engine")))
    profile_decode(params, cfg, prompts,
                   label="musicgen decode profile (8 slots, 4 steps each block)")
    return {"serve_musicgen": a["launches"], "serve_musicgen_h4": runs["h4"]["launches"],
            "serve_musicgen_swap": runs["swap"]["launches"]}


def serve_vlm():
    """qwen2-vl-2b served at every published width and all 28 layers (random
    bf16 weights): 8 requests of 448 tokens with the vision stub's extras
    (``_batch_requests``: 112 patches snapped to a 10 x 10 grid) + 32
    greedy tokens (worst replay 479, inside the default chunk of 512), which
    take the separate prefill; then 8 text-only requests of 512 + 32 through
    mixed dispatch.  Every decode-carrying forward launches
    ``paged_attention`` at G = 6 over 2 KV heads once a layer
    (:class:`counting`).  On the first 2 extras requests, recompute pressure
    (58 blocks admit both and cannot grow them, no swap tier: the replay
    re-prefills prompt + generated tokens in one chunk, the tail at
    (t, t, t)) and the static loop are held against the base run, partings
    only at reported near ties of the reference forward with the extras.
    Then a decode profile with ``paged_attn``'s share.  Returns each run's
    launches."""
    from repro_torch.launch.serve import _batch_requests
    cfg, params = _load(VLM_ARCH)
    reqs = _batch_requests(cfg, 8, VLM_PROMPT, SERVE_GEN, 0)
    prompts, extras = [r.prompt for r in reqs], [r.extras for r in reqs]
    chunk = 512
    a = serve(cfg, params, prompts, SERVE_GEN, extras=extras, prefill_chunk=chunk)
    s = a["summary"]
    if s["mixed"]["dispatches"]:
        raise AssertionError(f"vlm: extras requests took {s['mixed']['dispatches']} "
                             f"mixed dispatches")
    log("vlm serving (extras):", json.dumps(_serving_line(
        VLM_ARCH, a, layers=cfg.n_layers, requests=len(prompts), prompt=VLM_PROMPT,
        patches=int(extras[0]["patch_embeds"].shape[0]), generated=SERVE_GEN,
        chunk=chunk)))
    rng = np.random.default_rng(0)
    text = list(rng.integers(0, cfg.vocab, size=(8, VLM_TEXT_PROMPT), dtype=np.int32))
    b = serve(cfg, params, text, SERVE_GEN, prefill_chunk=chunk)
    if not b["summary"]["mixed"]["dispatches"]:
        raise AssertionError("vlm: text-only requests took no mixed dispatch")
    log("vlm serving (text only):", json.dumps(_serving_line(
        VLM_ARCH, b, requests=len(text), prompt=VLM_TEXT_PROMPT, generated=SERVE_GEN)))
    few = prompts[:SERVE_COMPARED]
    rec = serve(cfg, params, few, SERVE_GEN, extras=extras, prefill_chunk=chunk,
                n_blocks=58, swap_blocks=0)
    if rec["summary"]["preemptions"]["recompute"] <= 0:
        raise AssertionError(f"vlm recompute run: no recompute preemption "
                             f"{rec['summary']['preemptions']}")
    base = {rid: a["streams"][rid] for rid in range(SERVE_COMPARED)}
    n_equal = compare_streams(params, cfg, prompts, base, rec["streams"],
                              "vlm recompute pressure vs the default run", extras=extras)
    log("vlm serving (recompute pressure):", json.dumps(_serving_line(
        VLM_ARCH, rec, streams_equal_to_default=n_equal)))
    log("vlm static loop:", json.dumps(_static_vs_engine(
        cfg, params, prompts, a["streams"], "vlm serve_static vs the engine",
        extras=extras)))
    profile_decode(params, cfg, text, label="vlm decode profile (8 slots, 4 steps each block)")
    return {"serve_vlm": a["launches"], "serve_vlm_text": b["launches"],
            "serve_vlm_recompute": rec["launches"]}


# ---------------------------------------------------------------------------
# phases 17-19: training on one device
# ---------------------------------------------------------------------------

# train_card bounds, card (TF32 off) against the CPU in float32, one train
# step: |loss| difference, grad_norm's relative difference, and the worst
# leaf's normwise relative gradient difference max|g_card - g_cpu| /
# max|g_cpu| (a leaf whose CPU gradient is all 0 is held absolutely).  Each
# is at most 4x the worst measured over the 11 cases on an NVIDIA H100 80GB
# HBM3 (700 W): loss 9.54e-7, one float32 ulp at phi4's 12.57 (the two
# devices sum the log-sum-exp in other orders); grad_norm 1.89e-6 and the
# gradient leaves 8.56e-6, both xlstm's (the chunkwise mLSTM's float32
# exponential sums); the smallest move of the loss by shifted labels is
# 2.4e-3, far past every bound.
TRAIN_CARD_TOL = {"loss": 3.5e-6, "grad_norm": 7.5e-6, "grad_leaf": 3.4e-5}
TRAIN_SMOKE_SHAPE = (2, 32)           # batch x sequence of the smoke configs
PHI4_TRAIN_SHAPE = (4, 512)           # batch x sequence of train_phi4
PHI4_TRAIN_STEPS = 6
XLSTM_TRAIN_SHAPE = (8, 256)          # batch x sequence of train_xlstm


def kernel_launch_counts():
    """Every kernel's launch count, for a path that should launch none."""
    from repro_torch.kernels.act_pool.act_pool import act_pool_cuda
    from repro_torch.kernels.int8_mm.int8_mm import int8_mm_cuda
    from repro_torch.kernels.paged_attn import paged_attention
    from repro_torch.kernels.sc_mac import sc_mac_cuda
    return {"paged_attn": paged_attention, "sc_mac": sc_mac_cuda, "int8_mm": int8_mm_cuda,
            "act_pool": act_pool_cuda}


@contextlib.contextmanager
def no_kernel_launches(path, into):
    """Sets every kernel's launch count to 0, runs the block, reads the counts
    into ``into[kernel][path]`` and fails if any kernel launched (exact-mode
    training reaches none of them)."""
    counted = kernel_launch_counts()
    for fn in counted.values():
        fn.launches = 0
    yield
    torch.cuda.synchronize()
    for name, fn in counted.items():
        into.setdefault(name, {})[path] = fn.launches
        if fn.launches:
            raise AssertionError(f"{path}: {fn.launches} {name} launches in exact-mode training")


def _train_once(cfg, params, batch, opt_cfg):
    """One ``make_train_step`` call: (metrics as floats, the gradients the
    update received).  The step hands its gradients to ``adamw_update_``
    through the module; a pass-through keeps them."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw as adamw_mod
    from repro_torch.optim.adamw import adamw_init
    seen = {}

    def keep(fn):
        def inner(grads, *a, **k):
            seen["grads"] = grads
            return fn(grads, *a, **k)
        return inner

    with patched(adamw_mod, "adamw_update_", keep):
        _, _, m = make_train_step(cfg, opt_cfg, warmup=5)(params, adamw_init(params, opt_cfg),
                                                         batch)
    return {k: float(v) for k, v in m.items()}, seen["grads"]


def train_card_vs_cpu(launches):
    """One train step (loss, gradients, AdamW with float32 moments) of each of
    the ten smoke configs in float32 and of phi4-mini-3.8b's widths over 2
    layers (``remat="full"``, B = 1, S = 64) on the card and on the CPU,
    from the same weights (seeded on the card, copied to the host) and the
    same ``concrete_batch``: loss, ``grad_norm`` and every gradient leaf
    within ``TRAIN_CARD_TOL``.  This covers the MoE backward through a
    dropping dispatch (qwen3, deepseek), DeepSeek's MTP loss, Hymba's SSM
    scan, both xLSTM cells, musicgen's codebooks and qwen2-vl's extras.
    Labels shifted by one position move the card's loss past the bound."""
    import dataclasses

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.models import lm, registry
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.tree import leaves_with_path
    opt_cfg = AdamWConfig(moment_dtype="float32")
    cases = [(arch, registry.get_smoke(arch), TRAIN_SMOKE_SHAPE) for arch in registry.ARCH_IDS]
    cases.append(("phi4-mini-3.8b x 2 layers", _two_layers("phi4-mini-3.8b"), (1, 64)))
    worst = {"loss": 0.0, "grad_norm": 0.0, "grad_leaf": 0.0}
    lines = {}
    with no_kernel_launches("train_card", launches):
        for name, cfg, (B, S) in cases:
            t0 = time.perf_counter()
            card, host = _float32_weights(cfg)
            batch = concrete_batch(cfg, ShapeConfig("train", S, B, "train"), 0, 0)
            shifted = dict(batch, labels=batch["labels"].roll(1, dims=-1))
            with torch.no_grad():         # before the step updates the weights in place
                wrong = float(lm.loss_fn(card, {k: v.cuda() for k, v in shifted.items()},
                                         cfg)[0])
            m_card, g_card = _train_once(cfg, card, {k: v.cuda() for k, v in batch.items()},
                                         opt_cfg)
            m_cpu, g_cpu = _train_once(cfg, host, batch, opt_cfg)
            leaf_err, leaf_at = 0.0, None
            for (path, _, gc), (_, _, gh) in zip(leaves_with_path(g_card),
                                                 leaves_with_path(g_cpu)):
                d = (gc.cpu().float() - gh.float()).abs().max().item()
                scale = gh.float().abs().max().item()
                e = d / scale if scale > 0 else d
                if e > leaf_err:
                    leaf_err, leaf_at = e, path
            errs = {"loss": abs(m_card["loss"] - m_cpu["loss"]),
                    "grad_norm": abs(m_card["grad_norm"] - m_cpu["grad_norm"])
                    / m_cpu["grad_norm"], "grad_leaf": leaf_err}
            line = {"loss_card": m_card["loss"], "loss_cpu": m_cpu["loss"],
                    "grad_norm_cpu": m_cpu["grad_norm"],
                    **{f"{k}_err": v for k, v in errs.items()}, "worst_leaf": leaf_at,
                    "shifted_labels_loss_move": abs(wrong - m_card["loss"]),
                    "s": time.perf_counter() - t0}
            lines[name] = line
            for k, v in errs.items():
                worst[k] = max(worst[k], v)
                if v > TRAIN_CARD_TOL[k]:
                    raise AssertionError(f"train_card {name}: {k} error {v:.3e} > "
                                         f"{TRAIN_CARD_TOL[k]} ({line})")
            if line["shifted_labels_loss_move"] <= TRAIN_CARD_TOL["loss"]:
                raise AssertionError(f"train_card {name}: shifted labels move the loss by "
                                     f"{line['shifted_labels_loss_move']:.3e} only")
            del card, host
            free_device_memory()
    log("train card vs cpu:", json.dumps({"cases": lines, "worst": worst,
                                          "bounds": TRAIN_CARD_TOL}))
    return worst


def _profile_train_step(step, params, opt, batch):
    """One train step under the profiler: wall ms, device busy ms and share,
    device operations, the top device kernels and the AdamW update's share
    of the device time (a ``record_function`` range around it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.optim import adamw as adamw_mod

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    def op_dev_us(e):
        return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)

    with ranged(adamw_mod, "adamw_update_"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            step(params, opt, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(dev_us(e) for e in kernels)
    if busy_us <= 0:
        raise AssertionError("train profile: the profiler recorded no device time")
    adam_us = sum(op_dev_us(e) for e in events
                  if e.key == "adamw_update_" and e.device_type == DeviceType.CPU)
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    return {"wall_ms_profiled": wall * 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e6 / wall,
            "device_ops": sum(e.count for e in kernels),
            "adamw_update_device_ms": adam_us / 1e3, "adamw_update_share": adam_us / busy_us,
            "top_device_ms": {e.key[:60]: dev_us(e) / 1e3 for e in top}}


def train_phi4(launches):
    """phi4-mini-3.8b at every width and all 32 layers (4.451 B parameters,
    random bf16 weights from a seeded generator, ``remat="full"``) trained
    for ``PHI4_TRAIN_STEPS`` steps of the port's train step on batches of 4 x
    512 from ``concrete_batch``, once with float32 and once with int8 AdamW
    moments (no ``train_loop``: its last-step save would write ≈ 53 GB).
    Checks: the step-0 loss within 0.5 of ln V + 1/2 (the random fan-in
    head over unit-RMS inputs gives logits of unit variance, whose
    log-sum-exp is ln V + 1/2 on average: ln V alone is 0.5 off by
    construction), finite grad norms, moved parameters.  Reports step ms (median of steps 2-6), tokens/s, the share
    of the card's bf16 peak (``lm.model_flops`` over the step time), peak
    device memory, the loss curve, and a profile of one more step with
    float32 moments."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm, registry
    from repro_torch.nn.module import count_params, materialize
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    cfg = registry.get_config("phi4-mini-3.8b")
    B, S = PHI4_TRAIN_SHAPE
    shape = ShapeConfig("train", S, B, "train")
    n_params = count_params(lm.param_spec(cfg))
    out = {}
    for moments in ("float32", "int8"):
        with no_kernel_launches(f"train_phi4_{moments}", launches):
            t0 = time.perf_counter()
            params = materialize(lm.param_spec(cfg),
                                 torch.Generator(device="cuda").manual_seed(0), "cuda")
            opt_cfg = AdamWConfig(moment_dtype=moments)
            opt = adamw_init(params, opt_cfg)
            step = make_train_step(cfg, opt_cfg, warmup=5)
            probe = params["segments"][0]["mlp"]["w_up"][0, :4, :64].clone()
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            losses, norms, times = [], [], []
            for i in range(PHI4_TRAIN_STEPS):
                batch = concrete_batch(cfg, shape, 0, i, device="cuda")
                torch.cuda.synchronize()
                t = time.perf_counter()
                params, opt, m = step(params, opt, batch)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                times.append(time.perf_counter() - t)
            peak = torch.cuda.max_memory_allocated()
            prof = (_profile_train_step(step, params, opt,
                                        concrete_batch(cfg, shape, 0, PHI4_TRAIN_STEPS,
                                                       device="cuda"))
                    if moments == "float32" else None)
            moved = (params["segments"][0]["mlp"]["w_up"][0, :4, :64] - probe).abs().max().item()
            del params, opt
            free_device_memory()
        step_s = float(np.median(times[1:]))
        if prof is not None:      # the profiled step is slower: the profiler's host cost
            prof["device_busy_share_unprofiled"] = prof["device_busy_ms"] / (step_s * 1e3)
        line = {"moments": moments, "params": n_params, "batch": B, "seq": S,
                "setup_s": setup_s, "step_ms": step_s * 1e3,
                "step_ms_each": [t * 1e3 for t in times], "tokens_per_s": B * S / step_s,
                "bf16_peak_share": lm.model_flops(cfg, B * S) / step_s / BF16_FLOPS,
                "model_tflop_per_step": lm.model_flops(cfg, B * S) / 1e12,
                "peak_gb": peak / 1e9, "losses": losses, "grad_norms": norms,
                "param_moved": moved, "ln_vocab": math.log(cfg.vocab), "profile": prof}
        log(f"train_phi4 ({moments} moments):", json.dumps(line))
        if abs(losses[0] - (math.log(cfg.vocab) + 0.5)) > 0.5:
            raise AssertionError(f"train_phi4: step-0 loss {losses[0]:.4f} is not within 0.5 "
                                 f"of ln V + 1/2 = {math.log(cfg.vocab) + 0.5:.4f}")
        if not all(math.isfinite(x) for x in losses + norms):
            raise AssertionError(f"train_phi4: non-finite loss or grad norm {losses} {norms}")
        if not moved > 0:
            raise AssertionError("train_phi4: the parameters did not move")
        out[moments] = line
    return out


def _ckpt_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def train_xlstm(launches):
    """xlstm-350m at every width and all 24 layers (random bf16 weights,
    int8 moments) through the training CLI, ``python -m
    repro_torch.launch.train``, on batches of 8 x 256: ``--steps 6
    --save-every 2 --simulate-crash-at 4`` must exit 137 with the latest
    checkpoint at step 4; ``--resume`` must exit 0, print "resumed from step
    4" and save step 6.  That checkpoint (params, AdamW moments and step,
    data step) must equal bit for bit the final state of a straight
    in-process ``train_loop`` of 6 steps, which runs beside the crash run.
    Kernel launches are counted on that in-process run (``train_xlstm_loop``):
    the CLI's processes run the same code but count in their own memory.
    Reports the resumed run's step 5 (the CLI logs its last step; step 4
    carries the process's warm-up), each run's seconds and checkpoint bytes;
    the checkpoint directories are deleted after."""
    import re
    import shutil

    from repro_torch.checkpoint import ckpt
    from repro_torch.launch.train import train_loop
    from repro_torch.models import registry
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.tree import leaves_with_path
    B, S = XLSTM_TRAIN_SHAPE
    root = os.path.join(HERE, "build", "train_xlstm")
    shutil.rmtree(root, ignore_errors=True)
    run_dir = os.path.join(root, "cli")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "xlstm-350m",
            "--steps", "6", "--batch", str(B), "--seq", str(S), "--save-every", "2",
            "--int8-moments", "--ckpt-dir", run_dir]

    def start(extra):
        return subprocess.Popen(base + extra, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True), time.perf_counter()

    def finish(proc, t):
        try:
            out, err = proc.communicate(timeout=600)
        finally:
            proc.kill()
        found = {int(s): (float(l), float(ms)) for s, l, ms in re.findall(
            r"\[train\] step\s+(\d+)\s+loss (\S+)\s+(\d+) ms", out)}
        return proc.returncode, out, err, found, time.perf_counter() - t

    try:
        # the straight in-process run overlaps the crash run: both are
        # host-bound and leave the card mostly idle; the resumed run, whose
        # step 5 gives the step time, runs alone
        crash = start(["--simulate-crash-at", "4"])
        with no_kernel_launches("train_xlstm_loop", launches):
            t = time.perf_counter()
            straight, losses = train_loop(
                registry.get_config("xlstm-350m"), steps=6, batch=B, seq=S,
                ckpt_dir=os.path.join(root, "straight"), save_every=6,
                opt_cfg=AdamWConfig(moment_dtype="int8"), device="cuda")
            straight_s = time.perf_counter() - t
        rc, out, err, _, crash_s = finish(*crash)
        if rc != 137 or ckpt.latest_step(run_dir) != 4:
            raise AssertionError(f"train_xlstm crash run: rc {rc}, latest step "
                                 f"{ckpt.latest_step(run_dir)}\n{out}\n{err[-3000:]}")
        ckpt_bytes = _ckpt_bytes(os.path.join(run_dir, "step_000000004"))
        rc, out, err, resumed_steps, resume_s = finish(*start(["--resume"]))
        if (rc != 0 or "resumed from step 4" not in out or ckpt.latest_step(run_dir) != 6
                or 5 not in resumed_steps):
            raise AssertionError(f"train_xlstm resume: rc {rc}, latest step "
                                 f"{ckpt.latest_step(run_dir)}\n{out}\n{err[-3000:]}")
        resumed, _ = ckpt.restore(run_dir, 6, straight, verify=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    parted = {path: (a.float() - b.float()).abs().max().item()
              for (path, _, a), (_, _, b) in zip(leaves_with_path(resumed),
                                                 leaves_with_path(straight))
              if not torch.equal(a, b)}
    line = {"batch": B, "seq": S, "crash_run_s": crash_s, "resume_run_s": resume_s,
            "straight_in_process_s": straight_s, "step_ms": resumed_steps[5][1],
            "losses_straight": losses, "loss_resumed_5": resumed_steps[5][0],
            "leaves": sum(1 for _ in leaves_with_path(straight)), "leaves_parted": parted,
            "checkpoint_bytes": ckpt_bytes}
    log("train_xlstm:", json.dumps(line))
    if parted:
        raise AssertionError(f"train_xlstm: the resumed run's step 6 parts from the "
                             f"straight run's in {len(parted)} leaves: {parted}")
    return line


# phases that ``--phases`` may pick, for a focused run; no argument runs all
PICKABLE = ("paged_attn", "act_pool", "sc_mac", "odin_linear", "serve_sc", "serve_spec",
            "frontdoor", "serve_moe", "serve_dense", "hymba_card", "serve_hybrid",
            "mla_card", "serve_mla", "xlstm_card", "serve_xlstm", "serve_nemotron",
            "musicgen_card", "vlm_card", "serve_musicgen", "serve_vlm", "train_card",
            "train_phi4", "train_xlstm")


def run_picked(picked, name, smi):
    """The picked phases only (``serve_sc`` brings ``odin_linear``, whose
    checked row counts it needs; ``serve_spec`` and ``serve_dense`` the
    paged run of the serving traffic they are held against; ``serve_moe``,
    ``serve_mla`` and ``serve_nemotron`` the small models' card-vs-CPU
    check); no kernels line.  Each phase's seconds are printed."""
    if "paged_attn" in picked:
        check_paged_attn()
    if "act_pool" in picked:
        check_act_pool()
    if "sc_mac" in picked:
        check_sc_mac()
    if "odin_linear" in picked or "serve_sc" in picked:
        _, rows = check_odin_linear_full_width()
    if picked & {"serve_sc", "serve_spec", "frontdoor", "serve_dense"}:
        cfg, params, prompts, _ = load_phi4()
    if "serve_sc" in picked:
        serve_odin_sc(cfg, params, prompts, rows)
    if picked & {"serve_spec", "serve_dense"}:
        base = serve(cfg, params, prompts, 64)
    if "serve_spec" in picked:
        serve_spec(cfg, params, prompts, base["streams"],
                   base["summary"]["decode_tokens_per_s"])
    if "serve_dense" in picked:
        serve_dense(cfg, params, prompts, base["streams"])
    if "frontdoor" in picked:
        frontdoor(cfg, params, prompts)
    params = None                       # phi4's weights go before another model's
    free_device_memory()
    if "hymba_card" in picked:
        hymba_card_vs_cpu()
    if "serve_hybrid" in picked:
        serve_hybrid(*load_hymba())
        free_device_memory()
    if picked & {"serve_moe", "serve_mla", "serve_nemotron"}:
        small_model_card_vs_cpu()
    if "serve_moe" in picked:
        serve_moe(*load_qwen3())
        free_device_memory()
    if "mla_card" in picked:
        mla_card_vs_cpu()
        free_device_memory()
    if "serve_mla" in picked:
        serve_mla(*load_deepseek())
        free_device_memory()
    for phase, run in (("xlstm_card", xlstm_card_vs_cpu),
                       ("serve_xlstm", lambda: serve_xlstm(*load_xlstm())),
                       ("serve_nemotron", lambda: serve_nemotron(*load_nemotron())),
                       ("musicgen_card", musicgen_card_vs_cpu), ("vlm_card", vlm_card_vs_cpu),
                       ("serve_musicgen", serve_musicgen), ("serve_vlm", serve_vlm),
                       ("train_card", lambda: train_card_vs_cpu({})),
                       ("train_phi4", lambda: train_phi4({})),
                       ("train_xlstm", lambda: train_xlstm({}))):
        if phase in picked:
            t = time.perf_counter()
            run()
            free_device_memory()
            log(f"{phase} phase: {time.perf_counter() - t:.1f} s")
    log(smi)
    log(json.dumps({"ok": True, "phases": sorted(picked),
                    "device": {"platform": "gpu", "kind": name,
                               "count": torch.cuda.device_count()}}))
    return 0


class Laps:
    """Logs the seconds since the previous lap (or since it was made)."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, phase: str) -> None:
        now = time.perf_counter()
        log(f"{phase} phase: {now - self.t:.1f} s")
        self.t = now


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="On-card smoke run of the port (no "
                                             "arguments: every phase).")
    ap.add_argument("--phases", default="",
                    help=f"comma-separated subset of {', '.join(PICKABLE)}")
    picked = {x for x in ap.parse_args(argv).phases.split(",") if x}
    if not picked <= set(PICKABLE):
        ap.error(f"unknown phases {sorted(picked - set(PICKABLE))}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.act_pool.act_pool import SOURCE as ACT_POOL_SOURCE
    from repro_torch.kernels.int8_mm import int8_mm as int8_mod
    from repro_torch.kernels.paged_attn import ops as paged_ops
    from repro_torch.kernels.sc_mac import sc_mac as sc_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {name}")
    log(f"nvidia-smi: {smi}")
    t0 = time.perf_counter()
    texts = build.build_all([paged_ops.SOURCE, sc_mod.SOURCE, int8_mod.SOURCE,
                             ACT_POOL_SOURCE])
    log(f"kernel build (one nvcc each, in parallel): {time.perf_counter() - t0:.1f} s")
    for source, text in texts.items():
        log(f"--- nvcc {source.name} ---\n{text.strip()}")
    if picked:
        return run_picked(picked, name, smi)

    lap = Laps()
    attn_lines = check_paged_attn()
    report = attn_lines["decode_bf16"]
    lap("paged_attn")
    act_launches, act_lines = check_act_pool()
    lap("act_pool")
    sc_lines = check_sc_mac()
    lap("sc_mac")
    phi4_sc, sc_rows_checked = check_odin_linear_full_width()
    lap("odin_linear")
    int8_lines = check_int8_mm()
    check_rail_dot()
    lap("int8_mm, rail dot")
    small_model_card_vs_cpu()
    lap("small models")
    cfg, params, prompts, rng = load_phi4()
    paged_launches, exact_streams, exact_tps = serve_full_width(cfg, params, prompts, rng)
    lap("phi4 serving")
    spec_launches, spec_by_q = serve_spec(cfg, params, prompts, exact_streams, exact_tps)
    paged_launches.update(spec_launches)
    paged_launches.update(frontdoor(cfg, params, prompts))
    lap("serve_spec, frontdoor")
    odin = serve_odin(cfg, params, prompts, exact_streams, rng, sc_rows_checked)
    paged_launches.update(serve_int8=odin["int8"]["launches"], serve_sc=odin["sc"]["launches"])
    paged_launches.update(guarded_faults(cfg, params, rng))
    paged_launches.update(serve_dense(cfg, params, prompts, exact_streams))
    del params
    free_device_memory()
    lap("int8/sc serving, guarded, serve_dense")
    paged_launches["hymba_card_vs_cpu"] = hymba_card_vs_cpu()
    hymba_cfg, hymba_params, hymba_prompts = load_hymba()
    paged_launches.update(serve_hybrid(hymba_cfg, hymba_params, hymba_prompts))
    del hymba_params
    free_device_memory()
    lap("hymba")
    moe_cfg, moe_params, moe_prompts = load_qwen3()
    moe_launches, moe_by_q = serve_moe(moe_cfg, moe_params, moe_prompts)
    paged_launches.update(moe_launches)
    del moe_params
    free_device_memory()
    lap("serve_moe")
    paged_launches["mla_card_vs_cpu"] = mla_card_vs_cpu()
    free_device_memory()
    lap("mla_card")
    mla_cfg, mla_params, mla_prompts = load_deepseek()
    paged_launches.update(serve_mla(mla_cfg, mla_params, mla_prompts))
    del mla_params
    free_device_memory()
    lap("serve_mla")
    paged_launches["xlstm_card_vs_cpu"] = xlstm_card_vs_cpu()
    free_device_memory()
    lap("xlstm_card")
    xlstm_cfg, xlstm_params, xlstm_prompts = load_xlstm()
    paged_launches.update(serve_xlstm(xlstm_cfg, xlstm_params, xlstm_prompts))
    del xlstm_params
    free_device_memory()
    lap("serve_xlstm")
    nemo_cfg, nemo_params, nemo_prompts = load_nemotron()
    paged_launches.update(serve_nemotron(nemo_cfg, nemo_params, nemo_prompts))
    del nemo_params
    free_device_memory()
    lap("serve_nemotron")
    paged_launches["musicgen_card_vs_cpu"] = musicgen_card_vs_cpu()
    free_device_memory()
    lap("musicgen_card")
    paged_launches["vlm_card_vs_cpu"] = vlm_card_vs_cpu()
    free_device_memory()
    lap("vlm_card")
    paged_launches.update(serve_musicgen())
    free_device_memory()
    lap("serve_musicgen")
    paged_launches.update(serve_vlm())
    free_device_memory()
    lap("serve_vlm")
    train_launches = {}
    train_card_vs_cpu(train_launches)
    free_device_memory()
    lap("train_card")
    train_phi4(train_launches)
    lap("train_phi4")
    train_xlstm(train_launches)
    free_device_memory()
    lap("train_xlstm")
    paged_launches.update(train_launches["paged_attn"])
    sc_launches = {"cnn_experiment": cnn_experiment()[0],
                   "serve_sc": odin["sc"]["sc_mac_launches"], **train_launches["sc_mac"]}
    lap("cnn experiment")
    int8_launches = kernel_bench()
    lap("kernel bench")
    sc_rep = sc_lines["cnn1_conv0_b64_tree"]
    int8_rep = int8_lines["4096x4096x4096"]
    act_rep = act_lines["vgg_8x224x224x64_relu_max"]
    kernels = [{
        "name": "paged_attn", "route": "cuda", "status": "ok",
        "source": "src/repro_torch/kernels/paged_attn/csrc/paged_attn.cu",
        "replaces": "src/repro/kernels/paged_attn/paged_attn.py:53",
        "launches": sum(paged_launches.values()), "launches_by_path": paged_launches,
        "max_abs_err": report["max_abs_err"],
        "ms": report["ms"], "plain_ms": report["plain_ms"],
        "bound_ms": report["bound_ms"], "bound_by": report["bound_by"],
        "library_ms": report["library_ms"], "n_splits": report["n_splits"],
        "kernels_per_call": report["kernels_per_call"],
        "timed_cases": {k: {x: v.get(x) for x in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                  "library_ms", "n_splits", "launch_plan")}
                        for k, v in attn_lines.items() if "ms" in v},
        "launches_by_query_len_spec_paths": spec_by_q,
        "launches_by_query_len_moe_spec": moe_by_q,
    }, {
        "name": "sc_mac", "route": "cuda", "status": "ok",
        "source": "src/repro_torch/kernels/sc_mac/csrc/sc_mac.cu",
        "replaces": "src/repro/kernels/sc_mac/sc_mac.py:60",
        "launches": sum(sc_launches.values()), "launches_by_path": sc_launches,
        "shape": sc_rep["case"],
        "max_abs_err": max(x["max_abs_err"] for x in [*sc_lines.values(), *phi4_sc.values()]),
        "ms": sc_rep["ms"], "plain_ms": sc_rep["plain_ms"],
        "bound_ms": sc_rep["bound_ms"], "bound_by": sc_rep["bound_by"],
        "library_ms": None, "plan": sc_rep.get("plan"),
        "phi4_rows": {f"{proj}_{M}": {x: v.get(x) for x in
                                      ("ms", "bound_ms", "bound_ms_tree_count", "plan")}
                      for (proj, M), v in phi4_sc.items()},
    }, {
        "name": "int8_mm", "route": "cuda", "status": "ok",
        "source": "src/repro_torch/kernels/int8_mm/csrc/int8_mm.cu",
        "replaces": "src/repro/kernels/int8_mm/int8_mm.py:32",
        "launches": int8_launches,
        "launches_by_path": {"kernel_bench": int8_launches, **train_launches["int8_mm"]},
        "shape": int8_rep["case"],
        "max_abs_err": max(x["max_abs_err"] for x in int8_lines.values()),
        "ms": int8_rep["ms"], "plain_ms": int8_rep["plain_ms"],
        "bound_ms": int8_rep["bound_ms"], "bound_by": int8_rep["bound_by"],
        "library_ms": int8_rep["library_ms"],
        "library_ms_by_layout": int8_rep["library_ms_by_layout"], "tops": int8_rep["tops"],
    }, {
        "name": "act_pool", "route": "cuda", "status": "ok",
        "source": "src/repro_torch/kernels/act_pool/csrc/act_pool.cu",
        "replaces": "src/repro/kernels/act_pool/act_pool.py:36",
        "launches": act_launches,
        "launches_by_path": {"act_pool_entry": act_launches, **train_launches["act_pool"]},
        "shape": act_rep["case"],
        "max_abs_err": act_rep["max_abs_err"],
        "ms": act_rep["ms"], "plain_ms": act_rep["plain_ms"],
        "bound_ms": act_rep["bound_ms"], "bound_by": act_rep["bound_by"],
        "library_ms": None,
    }]
    log(f"chip_smoke: {time.perf_counter() - t0:.1f} s from the kernel build to the last phase")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
