"""Serving driver of the port — a thin CLI over the continuous-batching engine.

Usage:
  python -m repro_torch.launch.serve --arch phi4-mini-3.8b            # on the card
  python -m repro_torch.launch.serve --arch phi4-mini-3.8b --smoke --device cpu
  # open-loop scenario with a constrained KV pool (JSON metrics on stdout):
  python -m repro_torch.launch.serve --arch phi4-mini-3.8b --smoke \\
      --scenario mixed --requests 16 --slots 4 --kv-blocks 20
  # ODIN's stochastic-computing mode on every projection of the LM:
  python -m repro_torch.launch.serve --arch phi4-mini-3.8b --smoke --device cpu \\
      --odin-mode sc
  # n-gram self-speculative decode on repetition-heavy traffic:
  python -m repro_torch.launch.serve --arch phi4-mini-3.8b --smoke --device cpu \\
      --scenario repetitive --requests 4 --spec-ngram 4 --horizon 4
  # the engine as a streaming HTTP front door (SSE, 429 on overload):
  python -m repro_torch.launch.serve --arch phi4-mini-3.8b --smoke --device cpu \\
      --listen --port 8080 --max-queue 32 --tenant-rate 50
  # Hymba (sliding-window rings + SSM state, global layers on the pool):
  python -m repro_torch.launch.serve --arch hymba-1.5b --smoke --device cpu
  # DeepSeek-V3 (MLA's compressed latent cache per slot, MoE with a shared
  # expert; mixed dispatch and prefix sharing turn off by themselves):
  python -m repro_torch.launch.serve --arch deepseek-v3-671b --smoke --device cpu
  # xLSTM (mLSTM/sLSTM cell state per slot, no attention: no pool):
  python -m repro_torch.launch.serve --arch xlstm-350m --smoke --device cpu
  # MusicGen (prompts of [4, S] EnCodec tokens, 4 codebooks a frame):
  python -m repro_torch.launch.serve --arch musicgen-medium --smoke --device cpu
  # Qwen2-VL (M-RoPE; each prompt carries the vision stub's patch
  # embeddings and (t, h, w) position ids as request extras):
  python -m repro_torch.launch.serve --arch qwen2-vl-2b --smoke --device cpu
  # the static-batch loop over dense caches (the engine's parity baseline):
  python -m repro_torch.launch.serve --arch phi4-mini-3.8b --smoke --device cpu --static

``serve`` runs each prompt as a request through the engine; ``serve_static``
is the one-shot static-batch loop (one prefill, ``gen`` lockstep decode
steps on dense caches), the baseline the engine is held against.  Both
take the same numpy prompts for a seed, so their greedy tokens agree
where no preemption happens.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.data.synthetic import vlm_stub_extras
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import lm, registry
from repro_torch.nn.module import materialize
from repro_torch.serving import (SCENARIOS, FaultPlan, ReliabilityConfig,
                                 Request, ServingEngine, Tracer, make_requests)

__all__ = ["serve", "serve_static", "serve_listen", "main"]


def _extras(cfg, batch: int, prompt_len: int, seed: int):
    """The vision stub's extras for ``batch`` prompts (None for any other
    model): ``min(1024, prompt_len // 4)`` patches, as the JAX package's
    serving batch has."""
    if not cfg.vision_stub:
        return None
    return vlm_stub_extras(seed, batch=batch, seq=prompt_len, d_model=cfg.d_model,
                           n_patches=max(1, min(1024, prompt_len // 4)))


def _batch_requests(cfg, batch: int, prompt_len: int, gen: int, seed: int):
    """``batch`` random prompts of ``prompt_len`` tokens (``[K, prompt_len]``
    for a K-codebook model), all arriving at t=0; a vision-stub model's
    requests carry their extras (:func:`_extras`)."""
    rng = np.random.default_rng(seed)
    lead = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    toks = rng.integers(0, cfg.vocab, size=(batch, *lead, prompt_len), dtype=np.int32)
    ex = _extras(cfg, batch, prompt_len, seed)
    return [Request(rid=i, prompt=toks[i], max_new=gen,
                    extras=None if ex is None else {k: v[i] for k, v in ex.items()})
            for i in range(batch)]


def serve_static(cfg, *, batch: int, prompt_len: int, gen: int, seed: int = 0,
                 params=None, verbose: bool = True, device=None):
    """The static-batch loop: one prefill of the ``batch`` prompts of
    ``_batch_requests`` into fresh dense caches, then ``gen`` lockstep decode
    steps; every slot runs to the end.  ``params=None`` draws the weights the
    engine draws for ``seed``.  A vision-stub model's prefill takes the
    requests' extras.  Returns (generated [B, gen] (or [B, K, gen]) int32
    numpy array, decode tokens/s)."""
    dev = resolve_device(device)
    if params is None:
        gen_ = torch.Generator(device=dev).manual_seed(seed)
        params = materialize(lm.param_spec(cfg), gen_, dev)
    prompts = np.stack([r.prompt for r in _batch_requests(cfg, batch, prompt_len, gen,
                                                          seed)])
    data = {"tokens": prompts}
    data.update(_extras(cfg, batch, prompt_len, seed) or {})
    prefill = make_prefill_step(cfg, max_len=prompt_len + gen)
    decode = make_decode_step(cfg)
    t0 = time.perf_counter()
    last, caches = prefill(params, {k: torch.as_tensor(v, device=dev)
                                    for k, v in data.items()})
    tok = torch.argmax(last, dim=-1).to(torch.int32)[..., None]       # [B,1] / [B,K,1]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    outs = []
    t1 = time.perf_counter()
    for _ in range(gen):
        outs.append(tok)
        tok, caches = decode(params, caches, tok)
    generated = torch.cat(outs, dim=-1).cpu().numpy()              # syncs
    t2 = time.perf_counter()
    tps = batch * gen / max(t2 - t1, 1e-9)
    if verbose:
        print(f"[serve] static prefill {batch}x{prompt_len} on {dev} in "
              f"{(t1 - t0) * 1e3:.0f} ms; decode {gen} steps in "
              f"{(t2 - t1) * 1e3:.0f} ms  ({tps:.1f} tok/s)")
    return generated, tps


def serve(cfg, *, batch: int, prompt_len: int, gen: int, seed: int = 0,
          params=None, verbose: bool = True, slots: int | None = None,
          block_size: int | None = None, **engine_kwargs):
    """Serve ``batch`` random prompts through the engine.  Returns
    (generated [B, gen] (or [B, K, gen]) int32 numpy array, decode tokens/s)."""
    slots = slots or batch
    max_len = prompt_len + gen
    if block_size is None:
        block_size = next(b for b in (16, 8, 4, 2, 1) if max_len % b == 0)
    engine = ServingEngine(cfg, slots=slots, max_len=max_len,
                           block_size=block_size, params=params, seed=seed,
                           **engine_kwargs)
    reqs = _batch_requests(cfg, batch, prompt_len, gen, seed)
    summary = engine.run(reqs)
    generated = np.stack([np.stack(r.generated, axis=-1)
                          for r in sorted(reqs, key=lambda r: r.rid)])
    tps = summary["decode_tokens_per_s"]
    if verbose:
        print(f"[serve] engine {batch} reqs×{prompt_len}+{gen} over {slots} slots "
              f"on {engine.device}: prefill {summary['prefill_time_s']*1e3:.0f} ms, "
              f"decode {summary['decode_steps']} steps in "
              f"{summary['decode_time_s']*1e3:.0f} ms  ({tps:.1f} tok/s, "
              f"occupancy {summary['slot_occupancy']:.2f})")
    return generated, tps


def serve_listen(cfg, *, host: str = "127.0.0.1", port: int = 8080,
                 slots: int = 4, max_len: int = 128, block_size: int = 16,
                 max_queue: int = 64, tenant_rate: float | None = None,
                 tenant_burst: float | None = None,
                 heartbeat_s: float | None = None, params=None,
                 verbose: bool = True, **engine_kwargs):
    """Expose the engine as a streaming HTTP front door.

    ``POST /generate`` with ``{"prompt": [ids]}`` (or ``{"prompt_len": n}``
    for a random prompt) streams token/heartbeat/done events as SSE; an
    overloaded queue or an over-quota tenant gets ``429`` + ``Retry-After``,
    submissions during shutdown get ``503``.  SIGTERM/SIGINT drain
    gracefully: in-flight streams flush, then the engine summary prints.
    Blocks until shutdown; returns the final summary.
    """
    import asyncio

    from repro_torch.serving.frontdoor import FrontDoor, run_server

    engine = ServingEngine(cfg, slots=slots, max_len=max_len,
                           block_size=block_size, params=params,
                           **engine_kwargs)
    fd = FrontDoor(engine, max_queue=max_queue, tenant_rate=tenant_rate,
                   tenant_burst=tenant_burst, heartbeat_s=heartbeat_s)
    if verbose:
        print(f"[serve] front door on http://{host}:{port}/generate  "
              f"(slots={slots}, max_len={max_len}, queue≤{max_queue}"
              + (f", tenant quota {tenant_rate}/s" if tenant_rate else "")
              + f", {engine.device})  SIGTERM drains gracefully")
    try:
        asyncio.run(run_server(fd, host, port, vocab=cfg.vocab))
    except KeyboardInterrupt:
        pass
    summary = engine.summary()
    if verbose:
        print(f"[serve] drained: terminal {summary['terminal']}, "
              f"front door {fd.summary()}")
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain path)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--static", action="store_true",
                    help="run the static-batch loop (dense caches) instead of "
                         "the engine")
    ap.add_argument("--odin-mode", choices=["exact", "int8", "sc"], default=None,
                    help="execution mode for Linear layers (default: config's)")
    ap.add_argument("--no-paged", action="store_true",
                    help="keep the dense [slots, max_len] live caches instead "
                         "of the paged physical block store")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable shared-prompt block dedup")
    ap.add_argument("--no-mixed", action="store_true",
                    help="separate prefill and decode launches instead of the "
                         "fused mixed prefill+decode dispatch")
    ap.add_argument("--mixed-budget", type=int, default=None,
                    help="total query-row budget of one mixed dispatch "
                         "(default: prefill chunk + slots)")
    ap.add_argument("--horizon", type=int, default=1,
                    help="max decode steps fused into one dispatch")
    ap.add_argument("--spec-ngram", type=int, default=0, metavar="K",
                    help="n-gram self-speculative decode: draft K tokens per "
                         "inner step by prompt-lookup and verify them in one "
                         "multi-token forward (greedy only; 0 = off)")
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy argmax)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--sample-seed", type=int, default=0)
    ap.add_argument("--scenario", choices=sorted(SCENARIOS), default=None,
                    help="serve a synthetic open-loop workload instead")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=None)
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="device KV budget in blocks (forces preemption when low)")
    ap.add_argument("--swap-blocks", type=int, default=0)
    ap.add_argument("--block-size", type=int, default=None)
    ap.add_argument("--chunk", type=int, default=None, help="prefill chunk length")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON of the run")
    ap.add_argument("--trace-capacity", type=int, default=65536)
    ap.add_argument("--metrics-window", type=float, default=1.0)
    ap.add_argument("--xla-annotations", action="store_true",
                    help="wrap each step dispatch in a torch.profiler "
                         "record_function range (aligns profiles with spans)")
    ap.add_argument("--deadline-ms", type=float, default=None)
    ap.add_argument("--queue-timeout-ms", type=float, default=None)
    ap.add_argument("--degrade", action="store_true",
                    help="enable the graceful-degradation ladder")
    ap.add_argument("--reliability", action="store_true",
                    help="enable the PCRAM reliability layer with defaults")
    ap.add_argument("--endurance-budget", type=int, default=None)
    ap.add_argument("--no-wear-leveling", action="store_true")
    ap.add_argument("--scrub-rate", type=int, default=0, metavar="N")
    ap.add_argument("--drift-deadline-ms", type=float, default=None)
    ap.add_argument("--fault-plan", default=None, metavar="PATH",
                    help="seeded fault-injection plan (JSON, see repro_torch."
                         "serving.faults.FaultPlan); scenario mode only")
    # streaming front-door mode (ignores --batch/--scenario; clients bring
    # their own prompts over HTTP)
    ap.add_argument("--listen", action="store_true",
                    help="serve POST /generate as an SSE token stream through "
                         "the asyncio front door (429 + Retry-After on "
                         "overload, 503 while draining, SIGTERM drains)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--max-queue", type=int, default=64,
                    help="waiting-queue bound before typed 429 rejection")
    ap.add_argument("--max-len", type=int, default=None,
                    help="per-request prompt+gen cap for --listen "
                         "(default: --prompt-len + --gen)")
    ap.add_argument("--tenant-rate", type=float, default=None,
                    help="per-tenant emitted-token quota (tokens/s; off by "
                         "default)")
    ap.add_argument("--tenant-burst", type=float, default=None,
                    help="per-tenant bucket burst (default: --tenant-rate)")
    ap.add_argument("--heartbeat-ms", type=float, default=None,
                    help="idle-stream heartbeat period")
    args = ap.parse_args(argv)
    if args.static and (args.listen or args.scenario or args.trace_out):
        ap.error("--static runs the static loop alone (no --listen, --scenario "
                 "or --trace-out)")
    if args.fault_plan and not args.scenario:
        ap.error("--fault-plan requires --scenario (fault injection is bench/"
                 "test-mode only)")
    cfg = registry.get_smoke(args.arch) if args.smoke else registry.get_config(args.arch)

    reliability = None
    if (args.reliability or args.endurance_budget is not None
            or args.scrub_rate or args.drift_deadline_ms is not None):
        reliability = ReliabilityConfig(
            endurance_budget=args.endurance_budget,
            wear_leveling=not args.no_wear_leveling,
            scrub_rate=args.scrub_rate,
            drift_deadline_s=(args.drift_deadline_ms / 1e3
                              if args.drift_deadline_ms is not None else None))
    tracer = Tracer(capacity=args.trace_capacity) if args.trace_out else None
    engine_kw = dict(
        device=args.device, odin_mode=args.odin_mode, n_blocks=args.kv_blocks,
        swap_blocks=args.swap_blocks, paged=not args.no_paged,
        prefill_chunk=args.chunk,
        prefix_sharing=False if args.no_prefix_sharing else None,
        mixed=False if args.no_mixed else None, mixed_budget=args.mixed_budget,
        horizon=args.horizon, spec_ngram=args.spec_ngram, eos_id=args.eos_id,
        temperature=args.temperature,
        top_k=args.top_k, sample_seed=args.sample_seed, tracer=tracer,
        metrics_window=args.metrics_window, reliability=reliability,
        xla_annotations=args.xla_annotations,
        deadline_s=(args.deadline_ms / 1e3 if args.deadline_ms is not None else None),
        queue_timeout_s=(args.queue_timeout_ms / 1e3
                         if args.queue_timeout_ms is not None else None),
        degrade=args.degrade)

    if args.listen:
        block_size = args.block_size or 16
        max_len = args.max_len or (args.prompt_len + args.gen)
        max_len = -(-max_len // block_size) * block_size
        serve_listen(
            cfg, host=args.host, port=args.port, slots=args.slots or 4,
            max_len=max_len, block_size=block_size, max_queue=args.max_queue,
            tenant_rate=args.tenant_rate, tenant_burst=args.tenant_burst,
            heartbeat_s=(args.heartbeat_ms / 1e3
                         if args.heartbeat_ms is not None else None),
            seed=args.seed, **engine_kw)
    elif args.scenario:
        if args.fault_plan:
            with open(args.fault_plan) as fh:
                engine_kw["fault_plan"] = FaultPlan.from_json(fh.read())
        spec = dataclasses.replace(SCENARIOS[args.scenario], n_requests=args.requests)
        block_size = args.block_size or 16
        max_len = max(spec.prompt_buckets) + spec.shared_prefix + max(spec.gen_buckets)
        max_len = -(-max_len // block_size) * block_size
        engine = ServingEngine(cfg, slots=args.slots or 4, max_len=max_len,
                               block_size=block_size, seed=args.seed, **engine_kw)
        summary = engine.run(make_requests(cfg, spec, seed=args.seed))
        print(json.dumps({k: v for k, v in summary.items() if k != "requests"},
                         indent=2, allow_nan=False))
    elif args.static:
        if args.odin_mode is not None:
            cfg = cfg.with_overrides(odin_mode=args.odin_mode)
        generated, _ = serve_static(cfg, batch=args.batch, prompt_len=args.prompt_len,
                                    gen=args.gen, seed=args.seed, device=args.device)
        print("[serve] first request tokens:", generated[0].ravel()[:16])
    else:
        generated, _ = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                             gen=args.gen, seed=args.seed, slots=args.slots,
                             block_size=args.block_size, **engine_kw)
        print("[serve] first request tokens:", generated[0].ravel()[:16])
    if tracer is not None:
        tracer.export(args.trace_out)
        print(f"[serve] wrote {len(tracer)} trace events to {args.trace_out} "
              f"({tracer.dropped_events} dropped)")


if __name__ == "__main__":
    main()
