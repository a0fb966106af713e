"""The asyncio front door over the port's ServingEngine, phi4-mini smoke.

The chaos-client cases of ``tests/test_frontdoor.py`` run on the port's
engine (the JAX package's params in float32 through the bridge, float32 KV):
stream parity with ``engine.run`` and with the JAX front door over the JAX
engine, incremental token events, queue-full and degradation-denial
rejections with a retry-after, disconnect-cancel, a slow reader, deadline
expiry, shutdown mid-burst, a tenant quota storm, per-tenant metrics and
heartbeats; then one ``POST /generate`` over ``run_server`` on the loopback
interface, whose SSE token events equal the in-process stream.  Every engine
case asserts the no-leak invariants.  Async tests drive ``asyncio.run``
themselves."""
import asyncio
import json
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from serving_harness import materialize, mixed_spec, token_streams
from test_frontdoor import _assert_all_terminal, _assert_no_leaks, _collect

from repro.serving import FrontDoor as JaxFrontDoor
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import make_requests as jax_make_requests
from repro_torch.bridge import params_from_numpy
from repro_torch.models import registry as tregistry
from repro_torch.serving import (FrontDoor, Overloaded, Request, ServingEngine,
                                 ShuttingDown, TokenBucket, make_requests, run_server)

ARCH = "phi4-mini-3.8b"


@pytest.fixture(scope="module")
def models():
    jcfg, jparams = materialize(ARCH)
    host = jax.tree.map(np.asarray, jparams)
    return {"jax32": (jcfg.with_overrides(kv_dtype="float32"),
                      jax.tree.map(lambda a: a.astype(np.float32), jparams)),
            "torch32": (tregistry.get_smoke(ARCH).with_overrides(kv_dtype="float32"),
                        params_from_numpy(host, "cpu", dtype=torch.float32))}


def _engine(models, **kw):
    cfg, params = models["torch32"]
    kw.setdefault("slots", 3)
    kw.setdefault("max_len", 48)
    kw.setdefault("block_size", 8)
    return ServingEngine(cfg, params=params, device="cpu", **kw)


def _reqs(models, spec, seed=9):
    return make_requests(models["torch32"][0], spec, seed=seed)


def _through_front_door(fd_cls, eng, reqs):
    async def main():
        fd = fd_cls(eng, max_queue=16)
        await fd.start()
        outs = await asyncio.gather(*[_collect(fd.submit(r)) for r in reqs])
        await fd.aclose()
        return outs

    return asyncio.run(main())


# ---------------------------------------------------------------- units

def test_token_bucket_refill_and_debt():
    b = TokenBucket(rate=10.0, burst=5.0, now=0.0)
    assert b.admit_ok(0.0) and b.retry_after_s(0.0) == 0.0
    b.debit(8.0, 0.0)
    assert b.level == -3.0 and not b.admit_ok(0.0)
    assert b.retry_after_s(0.0) == pytest.approx(0.4)
    assert b.admit_ok(0.5)
    b.debit(0.0, 10.0)
    assert b.level == 5.0


def test_overloaded_typing():
    e = Overloaded("full", retry_after=1.5, tenant="t0")
    assert isinstance(e, RuntimeError)
    assert e.retry_after == 1.5 and e.tenant == "t0"
    s = ShuttingDown("bye")
    assert isinstance(s, Overloaded) and s.retry_after is None


def test_victim_key_ranks_over_quota_first():
    fd = FrontDoor.__new__(FrontDoor)      # key logic only, no event loop
    fd.tenant_rate = 1.0
    fd.buckets = {"hog": TokenBucket(1.0, 1.0, 0.0)}
    fd.buckets["hog"].debit(5.0, 0.0)
    old_hog = Request(rid=0, prompt=np.zeros(4, np.int32), max_new=4,
                      arrival=0.0, tenant="hog")
    young = Request(rid=1, prompt=np.zeros(4, np.int32), max_new=4,
                    arrival=9.0, tenant="polite")
    assert max([old_hog, young], key=fd._victim_key) is old_hog
    fd.buckets["hog"].debit(-10.0, 0.0)
    assert max([old_hog, young], key=fd._victim_key) is young


# ---------------------------------------------------------------- parity

@pytest.mark.parametrize("spec_ngram", [0, 4])
def test_stream_parity_with_engine_run_and_jax_front_door(models, spec_ngram):
    """The port's front-door streams equal its ``engine.run`` streams and the
    JAX front door's over the JAX engine on the same requests, with
    speculation off and on."""
    spec = mixed_spec(4)
    ref_reqs = _reqs(models, spec)
    _engine(models, spec_ngram=spec_ngram).run(ref_reqs)
    ref = token_streams(ref_reqs)

    eng = _engine(models, spec_ngram=spec_ngram)
    reqs = _reqs(models, spec)
    outs = _through_front_door(FrontDoor, eng, reqs)
    got = {r.rid: t for r, (t, _, _) in zip(reqs, outs)}
    assert got == ref
    for r, (toks, done, _) in zip(reqs, outs):
        assert done is not None and done.state == "done"
        assert done.n_tokens == len(toks) == r.n_generated
    assert eng.on_token is None and eng.sched.victim_key is None
    _assert_all_terminal(reqs)
    _assert_no_leaks(eng)

    jcfg, jparams = models["jax32"]
    jeng = JaxServingEngine(jcfg, params=jparams, slots=3, max_len=48, block_size=8,
                            spec_ngram=spec_ngram)
    jreqs = jax_make_requests(jcfg, spec, seed=9)
    jouts = _through_front_door(JaxFrontDoor, jeng, jreqs)
    assert {r.rid: t for r, (t, _, _) in zip(jreqs, jouts)} == got
    assert [d.n_tokens for _, d, _ in jouts] == [d.n_tokens for _, d, _ in outs]


def test_token_events_are_incremental(models):
    eng = _engine(models)
    req = _reqs(models, mixed_spec(1))[0]

    async def main():
        fd = FrontDoor(eng, max_queue=4)
        await fd.start()
        events = [ev async for ev in fd.submit(req)]
        await fd.aclose()
        return events

    events = asyncio.run(main())
    toks = [ev for ev in events if ev.kind == "token"]
    assert [ev.index for ev in toks] == list(range(len(toks)))
    ts = [ev.t for ev in toks]
    assert all(a <= b for a, b in zip(ts, ts[1:]))
    assert events[-1].kind == "done"
    assert sum(ev.kind == "done" for ev in events) == 1


# ---------------------------------------------------------------- backpressure

def test_queue_full_rejects_with_retry_after(models):
    eng = _engine(models, slots=2)
    reqs = _reqs(models, mixed_spec(8))

    async def main():
        fd = FrontDoor(eng, max_queue=2)
        await fd.start()
        streams, rejected = [], []
        for r in reqs:
            try:
                streams.append(fd.submit(r))
            except Overloaded as e:
                rejected.append(e)
        outs = await asyncio.gather(*[_collect(s) for s in streams])
        await fd.aclose()
        return outs, rejected, fd.summary()

    outs, rejected, summ = asyncio.run(main())
    assert rejected
    for e in rejected:
        assert isinstance(e, Overloaded) and not isinstance(e, ShuttingDown)
        assert e.retry_after is not None and e.retry_after >= 0.0
    assert summ["rejected_queue"] == len(rejected)
    assert summ["accepted"] == len(outs)
    for toks, done, _ in outs:
        assert done.state == "done" and len(toks) == done.n_tokens
    _assert_no_leaks(eng)


def test_degradation_denial_rejects_with_retry_after(models):
    eng = _engine(models, degrade=True)
    eng.degrade.level = 4                   # force admit_deny
    req = _reqs(models, mixed_spec(1))[0]

    async def main():
        fd = FrontDoor(eng, max_queue=8)
        await fd.start()
        try:
            with pytest.raises(Overloaded) as ei:
                fd.submit(req)
            return ei.value, fd.summary()
        finally:
            await fd.aclose()

    exc, summ = asyncio.run(main())
    assert exc.retry_after is not None and exc.retry_after >= 0.0
    assert summ["rejected_degrade"] == 1
    snap = eng.degrade.snapshot(eng._now())
    assert snap["retry_after_s"] is not None and snap["retry_after_s"] >= 0.0
    assert eng._by_rid == {}


# ---------------------------------------------------------------- disconnects

def test_disconnect_mid_stream_cancels_and_frees(models):
    eng = _engine(models, slots=2)
    reqs = _reqs(models, mixed_spec(3, gen_buckets=(24,)))

    async def main():
        fd = FrontDoor(eng, max_queue=8)
        await fd.start()

        async def flaky(r):
            stream = fd.submit(r)
            n = 0
            async for ev in stream:
                if ev.kind == "token":
                    n += 1
                    if n >= 3:
                        break
            await stream.aclose()
            return n

        got = await asyncio.gather(_collect(fd.submit(reqs[0])),
                                   flaky(reqs[1]), flaky(reqs[2]))
        await asyncio.sleep(0)
        await fd.shutdown()
        return got, fd.summary()

    (full, n1, n2), summ = asyncio.run(main())
    assert full[1].state == "done"
    assert n1 == 3 and n2 == 3
    assert summ["disconnect_cancels"] == 2
    assert summ["live_streams"] == 0
    assert sorted(r.state.value for r in reqs) == ["cancelled", "cancelled", "done"]
    for r in reqs[1:]:
        assert r.finish_reason == "disconnect"
    _assert_all_terminal(reqs)
    _assert_no_leaks(eng)


def test_slow_reader_loses_nothing(models):
    eng = _engine(models)
    reqs = _reqs(models, mixed_spec(2, gen_buckets=(24,)))

    async def main():
        fd = FrontDoor(eng, max_queue=8)
        await fd.start()

        async def slow(r):
            toks = []
            async for ev in fd.submit(r):
                await asyncio.sleep(0.002)
                if ev.kind == "token":
                    toks.append(ev.token)
            return toks

        outs = await asyncio.gather(_collect(fd.submit(reqs[0])), slow(reqs[1]))
        await fd.aclose()
        return outs

    (fast_toks, done, _), slow_toks = asyncio.run(main())
    assert done.state == "done"
    assert len(slow_toks) == reqs[1].n_generated == 24
    assert len(fast_toks) == reqs[0].n_generated
    _assert_all_terminal(reqs)
    _assert_no_leaks(eng)


def test_deadline_expiry_streams_timeout(models):
    eng = _engine(models, slots=1)
    reqs = _reqs(models, mixed_spec(2, gen_buckets=(24,)))

    async def main():
        fd = FrontDoor(eng, max_queue=8)
        await fd.start()
        s0 = fd.submit(reqs[0])
        reqs[1].deadline = eng._now()         # expires at the next step top
        s1 = fd.submit(reqs[1])
        outs = await asyncio.gather(_collect(s0), _collect(s1))
        await fd.aclose()
        return outs

    (t0, d0, _), (t1, d1, _) = asyncio.run(main())
    assert d0.state == "done" and len(t0) == 24
    assert d1.state == "timeout" and d1.finish_reason == "deadline"
    _assert_all_terminal(reqs)
    _assert_no_leaks(eng)


# ---------------------------------------------------------------- shutdown

def test_shutdown_mid_burst_flushes_and_rejects_late(models):
    eng = _engine(models, slots=2)
    reqs = _reqs(models, mixed_spec(6, gen_buckets=(24,)))

    async def main():
        fd = FrontDoor(eng, max_queue=8)
        await fd.start()
        streams = [fd.submit(r) for r in reqs[:5]]
        tasks = [asyncio.ensure_future(_collect(s)) for s in streams]
        for _ in range(30):
            await asyncio.sleep(0)
        shut = asyncio.ensure_future(fd.shutdown())
        await asyncio.sleep(0)
        with pytest.raises(ShuttingDown):
            fd.submit(reqs[5])
        outs = await asyncio.gather(*tasks)
        await shut
        return outs, fd.summary()

    outs, summ = asyncio.run(main())
    assert summ["rejected_draining"] == 1
    states = sorted(d.state for _, d, _ in outs)
    assert all(s in ("done", "cancelled") for s in states)
    assert "done" in states
    for r, (toks, done, _) in zip(reqs[:5], outs):
        assert done.n_tokens == len(toks) == r.n_generated
        if done.state == "cancelled":
            assert r.finish_reason == "drain" and r.t_admit is None
    _assert_all_terminal(reqs[:5])
    assert not reqs[5].terminal and reqs[5].rid not in eng._by_rid
    _assert_no_leaks(eng)


# ---------------------------------------------------------------- tenants

def test_tenant_quota_storm(models):
    eng = _engine(models)
    reqs = _reqs(models, mixed_spec(8, gen_buckets=(8,), n_tenants=2))
    hog = [r for r in reqs if r.tenant == "t0"]
    polite = [r for r in reqs if r.tenant == "t1"]

    async def main():
        fd = FrontDoor(eng, max_queue=16, tenant_rate=1e-3, tenant_burst=12.0)
        await fd.start()
        admitted, rejected = [], []
        for r in hog:
            try:
                admitted.append(asyncio.ensure_future(_collect(fd.submit(r))))
                await asyncio.gather(admitted[-1])
            except Overloaded as e:
                rejected.append(e)
        polite_outs = await asyncio.gather(*[_collect(fd.submit(r)) for r in polite])
        await asyncio.gather(*admitted)
        await fd.aclose()
        return rejected, polite_outs, fd.summary()

    rejected, polite_outs, summ = asyncio.run(main())
    assert rejected and summ["rejected_quota"] == len(rejected)
    for e in rejected:
        assert e.tenant == "t0"
        assert e.retry_after is not None and e.retry_after > 0.0
    assert all(d.state == "done" for _, d, _ in polite_outs)
    assert summ["tenant_buckets"]["t0"] <= 0.0
    _assert_no_leaks(eng)


def test_per_tenant_metrics_and_bills(models):
    eng = _engine(models)
    reqs = _reqs(models, mixed_spec(4, n_tenants=2))

    async def main():
        fd = FrontDoor(eng, max_queue=16)
        await fd.start()
        await asyncio.gather(*[_collect(fd.submit(r)) for r in reqs])
        await fd.aclose()

    asyncio.run(main())
    s = eng.summary()
    assert set(s["tenants"]) == {"t0", "t1"}
    for agg in s["tenants"].values():
        assert agg["requests"] == 2
        assert agg["terminal"]["done"] == 2
        assert agg["generated_tokens"] > 0
        assert agg["energy_mj"] > 0.0
        assert agg["ttft_s"]["p50"] >= 0.0
    assert sum(a["generated_tokens"] for a in s["tenants"].values()) \
        == s["engine_stats"]["generated_tokens"]
    assert {r["tenant"] for r in s["requests"]} == {"t0", "t1"}
    hists = s["metrics"]["histograms"]
    assert "ttft_s/t0" in hists and "ttft_s/t1" in hists


# ---------------------------------------------------------------- heartbeats

def test_heartbeats_on_idle_streams(models):
    eng = _engine(models, slots=1)
    reqs = _reqs(models, mixed_spec(2, gen_buckets=(24,)))

    async def main():
        fd = FrontDoor(eng, max_queue=8, heartbeat_s=1e-6)
        await fd.start()
        s0 = fd.submit(reqs[0])
        first_kind = {}

        async def watch(r, stream):
            beats = 0
            async for ev in stream:
                first_kind.setdefault(r.rid, ev.kind)
                if ev.kind == "heartbeat":
                    beats += 1
                    assert ev.state in ("queued", "running", "swapped")
            return beats

        s1 = fd.submit(reqs[1])
        b0, b1 = await asyncio.gather(watch(reqs[0], s0), watch(reqs[1], s1))
        await fd.aclose()
        return b0, b1, first_kind, fd.summary()

    b0, b1, first_kind, summ = asyncio.run(main())
    assert b1 > 0 and summ["heartbeats"] == b0 + b1
    assert first_kind[reqs[1].rid] == "heartbeat"
    _assert_all_terminal(reqs)
    _assert_no_leaks(eng)


# ---------------------------------------------------------------- HTTP/SSE

def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def _post_generate(port: int, body: dict):
    """One ``POST /generate`` on the loopback interface; returns (status
    line, the SSE events' JSON payloads)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = json.dumps(body).encode()
    writer.write(b"POST /generate HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                 + f"Content-Length: {len(data)}\r\n\r\n".encode() + data)
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(), timeout=120)
    writer.close()
    await writer.wait_closed()
    head, _, rest = raw.decode().partition("\r\n\r\n")
    events = [json.loads(line[len("data: "):]) for line in rest.split("\n")
              if line.startswith("data: ")]
    return head.splitlines()[0], events


def test_run_server_sse_stream_equals_in_process_stream(models):
    """One request over ``run_server`` on 127.0.0.1: its SSE token events
    equal the stream the same request gets in process."""
    prompt = _reqs(models, mixed_spec(1))[0].prompt
    ref = Request(rid=0, prompt=prompt, max_new=12)
    _engine(models).run([ref])

    async def main():
        fd = FrontDoor(_engine(models), max_queue=4)
        ready = asyncio.Event()
        port = _free_port()
        server = asyncio.ensure_future(run_server(
            fd, "127.0.0.1", port, vocab=models["torch32"][0].vocab,
            install_signals=False, ready=ready))
        await asyncio.wait_for(ready.wait(), timeout=30)
        try:
            return await _post_generate(port, {"prompt": prompt.tolist(),
                                               "max_new": 12})
        finally:
            server.cancel()
            try:
                await server
            except asyncio.CancelledError:
                pass

    status, events = asyncio.run(main())
    assert status == "HTTP/1.1 200 OK"
    toks = [tuple(e["token"]) for e in events if e["kind"] == "token"]
    assert toks == token_streams([ref])[0]
    assert [e["index"] for e in events if e["kind"] == "token"] == list(range(12))
    assert events[-1]["kind"] == "done" and events[-1]["state"] == "done"
    assert events[-1]["n_tokens"] == 12
