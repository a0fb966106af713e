"""On-card smoke run of the PyTorch/CUDA port (run from the repository root:
``python3 chip_smoke.py``; needs one CUDA card, no arguments).

Phases, each fatal on failure:

1. report the card (``nvidia-smi`` name and power limit), the torch/CUDA
   versions, and build the port's CUDA kernel from ``src/`` with ``nvcc``;
2. hold each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it, and time kernel, plain version and the
   library yardstick against the kernel's memory bound;
3. check a small model end to end: the engine on the card (CUDA kernel) and
   on the CPU (plain path) must emit the same greedy tokens in float32;
4. serve full-width phi4-mini-3.8b (all 32 layers, random bf16 weights from a
   seeded generator) through the port's ServingEngine with its defaults
   (mixed dispatch, prefix sharing) and show that every forward that carried
   a decode row or a mixed tile went through the kernel; then a short run
   with mixed dispatch off whose streams must equal the first run's, except
   where they part at a near tie of the logits (reported, see
   ``check_divergence``); then 16 requests sharing a prompt prefix in a
   tight pool with a swap tier (prefix hits, copy-on-write forks, swap
   preemptions), served with horizon 1 and horizon 4, whose streams are held
   against each other the same way; then a profile of plain decode steps.

The last two lines of stdout are ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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
# |kernel - plain| <= atol + rtol·|plain|, elementwise.  float32: the JAX
# suite's bound.  bfloat16: kernel and plain version both accumulate in
# float32 and round once to bf16, so they may part by one bf16 ulp, which is
# at most 2^-7·|x|; atol covers outputs near 0.
TOL = {torch.float32: (3e-5, 0.0),
       torch.bfloat16: (1e-5, 2.0 ** -7)}


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, after a warm-up."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 2: paged attention kernel vs its plain version
# ---------------------------------------------------------------------------

def attn_case(name, *, B=8, Q=1, H=24, Hkv=8, D=128, bs=16, P=64, window=0,
              q_dtype=torch.bfloat16, kv="bf16", special=None, seed=0, copies=1):
    """Inputs for one kernel check; ``copies`` distinct pools so that timed
    launches cycle through more bytes than the 50 MB L2 holds."""
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
    lengths = np.linspace(Q, P * bs, B).astype(np.int32)       # spread up to P·bs
    rng.shuffle(lengths)
    if special == "zero_len":
        lengths[0] = 0
        lengths[1] = 1                      # rows of queries 0..Q-2 see no key
    lengths = torch.as_tensor(lengths, device=dev)
    return dict(name=name, q=q if Q > 1 else q[:, 0].contiguous(), pools=pools,
                tables=tables, lengths=lengths, window=window, Q=Q, G=H // Hkv,
                kv_scale=16.0 if kv == "int8" else None, special=special)


def tol_excess(out, ref):
    """Per-slot max of |out - ref| / (atol + rtol·|ref|): within tolerance
    where it is <= 1."""
    atol, rtol = TOL[ref.dtype]
    ref = ref.float()
    e = (out.float() - ref).abs() / (atol + rtol * ref.abs())
    return e.reshape(e.shape[0], -1).amax(dim=1)


def live_bytes_and_ops(c):
    """Bytes the function must move (q, out, tables, lengths once; every
    visible K/V row once) and its multiply-adds (QK and PV over visible
    keys)."""
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
    return kv_bytes + io, ops


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
    ]
    report = None
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
        nbytes, ops = live_bytes_and_ops(c)
        peak = BF16_FLOPS if c["q"].dtype == torch.bfloat16 else F32_FLOPS
        bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / peak) * 1e3
        bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / peak else "operations"
        line = {"case": c["name"], "max_abs_err": err, "atol_rtol": TOL[ref.dtype],
                "max_tol_excess": excess, "one_key_short_min_excess": short.min().item(),
                "bound_ms": bound_ms, "bound_by": bound_by, "live_bytes": nbytes}
        if c["name"] == "decode_bf16":
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

            # interleaved: plain, kernel, kernel, plain
            p1 = cuda_ms(plain, 20)
            k1 = cuda_ms(kernel, 100)
            k2 = cuda_ms(kernel, 100)
            p2 = cuda_ms(plain, 20)
            lib = cuda_ms(library_call(c), 100)
            line.update(ms=min(k1, k2), plain_ms=min(p1, p2), library_ms=lib,
                        kernel_ms_runs=[k1, k2], plain_ms_runs=[p1, p2])
            report = line
        log("paged_attn check:", json.dumps(line))
    return report


# ---------------------------------------------------------------------------
# phases 3-4: serving
# ---------------------------------------------------------------------------

def small_model_card_vs_cpu():
    """A 2-layer model with the kernel's head dim: greedy streams of the
    engine on the card (CUDA kernel) equal those on the CPU (plain path)."""
    from repro_torch.configs.base import AttnConfig, BlockConfig, ModelConfig
    from repro_torch.models import lm
    from repro_torch.nn.module import materialize
    from repro_torch.serving import ServingEngine, WorkloadSpec, make_requests
    from repro_torch.tree import tree_map

    cfg = ModelConfig(name="smoke-d64", d_model=256, vocab=512, kv_dtype="float32",
                      blocks=(BlockConfig(kind="dense", n_layers=2, d_ff=512,
                                          attn=AttnConfig(n_heads=4, n_kv_heads=2,
                                                          d_head=64)),))
    gen = torch.Generator().manual_seed(0)
    params = tree_map(lambda t: t.float(), materialize(lm.param_spec(cfg), gen, "cpu"))
    spec = WorkloadSpec(n_requests=5, rate=1e9, prompt_buckets=(24, 40), gen_buckets=(8, 20))
    streams = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        eng = ServingEngine(cfg, slots=3, max_len=64, block_size=16, params=p,
                            device=dev, prefill_chunk=16)
        reqs = make_requests(cfg, spec, seed=1)
        eng.run(reqs)
        streams[dev] = {r.rid: [int(np.ravel(t)[0]) for t in r.generated] for r in reqs}
    if streams["cpu"] != streams["cuda"]:
        raise AssertionError(f"small model: card {streams['cuda']} != cpu {streams['cpu']}")
    n = sum(len(s) for s in streams["cuda"].values())
    log(f"small model (d_head 64, float32): card == cpu greedy streams, {n} tokens")


def serve_full_width():
    from repro_torch.kernels.paged_attn import paged_attention
    from repro_torch.models import lm, registry
    from repro_torch.nn.module import count_params, materialize
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.serving import engine as engine_mod

    cfg = registry.get_config("phi4-mini-3.8b")
    n_layers = cfg.n_layers
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = materialize(lm.param_spec(cfg), gen, "cuda")
    torch.cuda.synchronize()
    log(f"phi4-mini-3.8b: {count_params(lm.param_spec(cfg)) / 1e9:.3f} B params "
        f"materialized in bf16 on the card in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = list(rng.integers(0, cfg.vocab, size=(8, 512), dtype=np.int32))

    def run(prompts, max_new, **kw):
        """Serve ``prompts`` (all arriving at once) greedily; every forward
        that carries a decode row or a mixed tile must launch the kernel
        once per layer."""
        eng = ServingEngine(cfg, slots=8, max_len=1024, block_size=16,
                            prefill_chunk=256, params=params, **kw)
        calls = {"forwards": 0}
        for attr in ("_decode", "_mixed"):
            fn = getattr(eng, attr)

            def counted(*a, _fn=fn, **k):
                calls["forwards"] += 1
                return _fn(*a, **k)
            setattr(eng, attr, counted)
        make_horizon = engine_mod.make_serving_decode_horizon

        def counted_horizon(cfg_, H, **k):
            fn = make_horizon(cfg_, H, **k)

            def step(*a, **kk):
                calls["forwards"] += H
                return fn(*a, **kk)
            return step
        reqs = [Request(rid=i, prompt=pr, max_new=max_new) for i, pr in enumerate(prompts)]
        torch.cuda.reset_peak_memory_stats()
        engine_mod.make_serving_decode_horizon = counted_horizon
        paged_attention.launches = 0
        try:
            t = time.perf_counter()
            summary = eng.run(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = paged_attention.launches
        finally:
            engine_mod.make_serving_decode_horizon = make_horizon
        streams = {r.rid: [int(np.ravel(x)[0]) for x in r.generated] for r in reqs}
        for r in reqs:
            if r.state.name != "DONE" or len(streams[r.rid]) != max_new:
                raise AssertionError(f"request {r.rid} ended {r.state} with "
                                     f"{len(streams[r.rid])}/{max_new} tokens")
            if not all(0 <= x < cfg.vocab for x in streams[r.rid]):
                raise AssertionError(f"request {r.rid}: token out of range")
        if launches <= 0 or launches != n_layers * calls["forwards"]:
            raise AssertionError(f"paged_attention launches {launches} != "
                                 f"{n_layers} x {calls['forwards']} forwards")
        return dict(summary=summary, streams=streams, launches=launches,
                    forwards=calls["forwards"], wall=wall,
                    peak=torch.cuda.max_memory_allocated())

    def compare(base, other, prompts, what):
        n_equal = sum(base[rid] == other[rid] for rid in base)
        log(f"{what}: {n_equal}/{len(base)} streams equal")
        for rid in base:
            check_divergence(params, cfg, prompts[rid], base[rid], other[rid], rid)

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
    return a["launches"], result


# bf16 logits of magnitude 4-8 carry 2^-5 steps; 0.125 is four of them.  The
# mixed tile and the plain decode step run the same math at different batch
# shapes, and eager PyTorch on the card picks its GEMM and reduction
# algorithms per shape, so their bf16 roundings differ.
LOGIT_TIE_TOL = 0.125


def check_divergence(params, cfg, prompt, a, b, rid):
    """Two greedy streams of one request may part only at a near tie: at the
    first differing step both tokens must be the reference forward's top two,
    with logits within LOGIT_TIE_TOL.  Each such step is reported."""
    from repro_torch.models import lm
    t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if t is None:
        return
    ctx = torch.as_tensor(np.concatenate([prompt, np.asarray(a[:t], np.int32)]),
                          device="cuda")[None]
    with torch.no_grad():
        logits = lm.forward(params, ctx, cfg)[0][0, -1].float()
    top = torch.topk(logits, 2)
    gap = abs(logits[a[t]].item() - logits[b[t]].item())
    report = {"rid": rid, "step": t, "mixed_token": a[t], "unmixed_token": b[t],
              "reference_top2": top.indices.tolist(),
              "reference_top2_gap": (top.values[0] - top.values[1]).item(),
              "gap_between_tokens": gap, "tol": LOGIT_TIE_TOL}
    log("stream divergence at a near tie:", json.dumps(report))
    if set(top.indices.tolist()) != {a[t], b[t]} or gap > LOGIT_TIE_TOL:
        raise AssertionError(f"request {rid}: mixed on/off streams part at step {t} "
                             f"without a near tie: {report}")


def profile_decode(params, cfg, prompts):
    """Plain decode steps of the full-width engine, 8 slots: after four
    warm-up steps, four timed without the profiler, four under it and four
    more without it.  Reports device time by kernel, device operations per
    step, and the busy share of each wall time.  Kernel durations come from
    the profiled steps; the unprofiled share divides them by the mean wall
    time of the unprofiled steps around them, same engine and batch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import Request, ServingEngine
    eng = ServingEngine(cfg, slots=8, max_len=1024, block_size=16,
                        prefill_chunk=256, params=params, mixed=False)
    for i in range(8):
        eng.submit(Request(rid=i, prompt=prompts[i], max_new=32))
    while any(r.n_generated < 2 for r in eng.sched.running.values()) \
            or len(eng.sched.running) < 8:
        eng.step()

    def four_steps():
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(4):
            eng.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / 4

    four_steps()
    before = four_steps()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_prof = four_steps()
    after = four_steps()
    wall_plain = (before + after) / 2
    if len(eng.sched.running) != 8:
        raise AssertionError("decode profile: a request finished inside the timed steps")
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side events only: an operator's own row repeats its kernels' time
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = sum(dev_us(e) for e in kernels) / 4e6
    if busy <= 0:
        raise AssertionError("decode profile: the profiler recorded no device time")
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with open(os.path.join(HERE, "build", "profile_decode.txt"), "w") as fh:
        fh.write(events.table(sort_by="self_cuda_time_total", row_limit=40))
    log("decode profile (8 slots, 4 steps each block):", json.dumps({
        "wall_ms_per_step_unprofiled": wall_plain * 1e3,
        "wall_ms_per_step_unprofiled_runs": [before * 1e3, after * 1e3],
        "wall_ms_per_step_profiled": wall_prof * 1e3,
        "device_busy_ms_per_step": busy * 1e3,
        "device_busy_share_unprofiled": busy / wall_plain,
        "device_busy_share_profiled": busy / wall_prof,
        "device_ops_per_step": sum(e.count for e in kernels) / 4,
        "top_device_ms_per_step": {e.key[:60]: dev_us(e) / 4e3 for e in top}}))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attn import ops as paged_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {name}")
    t0 = time.perf_counter()
    text = build.build(paged_ops.SOURCE)
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    log(f"--- nvcc {paged_ops.SOURCE.name} ---\n{text.strip()}")

    report = check_paged_attn()
    small_model_card_vs_cpu()
    launches, _ = serve_full_width()
    kernels = [{
        "name": "paged_attn", "route": "cuda", "status": "ok",
        "source": "src/repro_torch/kernels/paged_attn/csrc/paged_attn.cu",
        "replaces": "src/repro/kernels/paged_attn/paged_attn.py:53",
        "launches": launches, "max_abs_err": report["max_abs_err"],
        "ms": report["ms"], "plain_ms": report["plain_ms"],
        "bound_ms": report["bound_ms"], "bound_by": report["bound_by"],
        "library_ms": report["library_ms"],
    }]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
