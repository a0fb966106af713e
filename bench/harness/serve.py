"""The closed-loop serving driver: ``repro_torch.serving.ServingEngine``
through ``submit`` and ``step``, one client a slot-sized stream of
requests, each client sending its next request the moment its last token
arrives (no think time).

Set-up makes the weights, builds the engine, and serves the loop until
``warmup_requests`` requests have completed, which fills every slot and
runs the tile shapes the mix makes.  The window then serves the same loop
for ``seconds``; every dispatch ends in the engine's token readback, so
the host clock reads a finished device step.  With ``trace`` the engine's
``Tracer`` records its dispatch spans and the profiler the last
``profile_seconds`` of the window; the spans before that are the ones
the per-layer readers take.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from harness import port
from harness.profile import DeviceProfile
from harness.traffic import ClosedLoop, rng_for
from reference.weights import dims, make_weights
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.trace import Tracer

__all__ = ["run"]


def run(cfg: Dict, traffic: Dict, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float) -> Dict:
    m = dims(cfg)
    mcfg = port.model_config(cfg)
    w = make_weights(cfg, seed, device)
    params = port.param_tree(w, mcfg)
    times: Dict[int, List[float]] = {}
    submitted: Dict[int, float] = {}

    def on_token(req, tok, now):
        times[req.rid].append(time.perf_counter())

    eng_args = dict(traffic["engine"])
    tracer = Tracer(capacity=1 << 20) if trace else None
    eng = ServingEngine(mcfg, params=params, device=device, on_token=on_token,
                        clock=time.perf_counter, tracer=tracer, xla_annotations=trace,
                        **eng_args)
    loop = ClosedLoop(traffic, m["V"], seed)
    # each client's request in flight
    clients: List[Request] = [None] * int(traffic["clients"])
    reqs: Dict[int, Request] = {}
    prefill_rows: List = []          # (time, start, rows) of every prefill chunk run
    next_rid = [0]

    def submit(c: int) -> None:
        prompt, out = loop.next()
        rid = next_rid[0]
        next_rid[0] += 1
        now = time.perf_counter()
        r = Request(rid=rid, prompt=prompt, max_new=out, arrival=eng._now())
        times[rid] = []
        submitted[rid] = now
        reqs[rid] = r
        clients[c] = r
        eng.submit(r)

    def step() -> int:
        """One engine step, the clients that finished resubmitting; returns
        how many requests finished."""
        live = list(clients)
        before = [r.n_prefill_tokens for r in live]
        with torch.profiler.record_function("bench.engine_step"):
            eng.step()
        now = time.perf_counter()
        for r, b in zip(live, before):
            if r.n_prefill_tokens > b:
                c = r.n_prefill_tokens - b
                prefill_rows.append((now, r.prefill_pos - c, c))
        done = 0
        for c, r in enumerate(clients):
            if r.terminal:
                done += 1
                submit(c)
        return done

    for c in range(len(clients)):
        submit(c)
    finished = 0
    while finished < int(traffic["warmup_requests"]):
        finished += step()
    prof = DeviceProfile(device) if trace else None
    if prof is not None:
        prof.warm()
    profile_s = float(traffic.get("profile_seconds", 8.0))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    profiling = False
    while time.perf_counter() - t0 < seconds:
        if prof is not None and not profiling and time.perf_counter() - t0 >= seconds - profile_s:
            prof.start()
            profiling = True
        step()
    t1 = time.perf_counter()
    if prof is not None and not profiling:
        # a window shorter than its last step: trace one step past it
        prof.start()
        profiling = True
        step()
    if profiling:
        prof.stop()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    record = {
        "kind": "serve", "t0": t0, "t1": t1, "setup_s": setup_s, "memory_peak_bytes": peak,
        "block_size": int(eng_args.get("block_size", 16)),
        "requests": [{"rid": r.rid, "t_submit": submitted[r.rid], "times": times[r.rid],
                      "prompt_len": r.prompt_len, "max_new": r.max_new,
                      "state": r.state.value} for r in reqs.values()],
        "prefill_rows": prefill_rows,
    }
    if trace:
        t_engine = eng._t0
        record["spans"] = [
            {"name": e.name, "ts": e.ts + t_engine, "dur": e.dur, "args": dict(e.args or {})}
            for e in tracer.events() if e.ph == "X" and e.cat == "dispatch"]
        record["profile"] = prof.reduce()
        record["profile"]["t0"], record["profile"]["t1"] = prof.t0, prof.t1
    # the sample the reference checks: requests finished inside the run,
    # the longest among them, then others drawn from the seed
    done = [r for r in reqs.values()
            if r.state.value == "done" and t0 < times[r.rid][-1] <= t1]
    sample = []
    if done:
        longest = max(done, key=lambda r: (r.prompt_len + r.n_generated, -r.rid))
        rest = [r for r in done if r is not longest]
        order = rng_for(seed, 2).permutation(len(rest))
        sample = [longest] + [rest[i] for i in order]
        total, keep = 0, []
        for r in sample:
            keep.append(r)
            total += r.n_generated
            if total >= int(traffic["check_tokens"]):
                break
        sample = keep
    record["check_sample"] = [
        {"rid": r.rid, "prompt": np.asarray(r.prompt, np.int64),
         "served": np.asarray([int(np.ravel(t)[0]) for t in r.generated], np.int64)}
        for r in sample]
    del eng, params, w, tracer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return record
