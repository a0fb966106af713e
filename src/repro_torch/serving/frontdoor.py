"""Async streaming front door: backpressure, tenant QoS, failure semantics.

:class:`FrontDoor` wraps a synchronous :class:`~repro_torch.serving.engine.\
ServingEngine` in an asyncio driver task and exposes ``submit(request)`` as
an **async token stream**.  The contract it adds on top of the engine:

* **Bounded-queue backpressure** — when the scheduler's waiting queue holds
  ``max_queue`` requests, or the degradation ladder has reached
  ``admit_deny``, ``submit`` raises a typed :class:`Overloaded` carrying a
  ``retry_after`` hint in relative seconds (the HTTP-429 shape — the
  :func:`run_server` wrapper maps it to ``429`` + ``Retry-After``).
* **Per-tenant QoS** — each tenant gets a token bucket metered on *emitted*
  tokens (accept-aware: a speculative step that emits 4 accepted tokens
  debits 4), so quota reflects delivered service, not requested budgets.
  An exhausted bucket rejects new admissions with ``retry_after`` sized to
  the refill, and a preemption-victim hook ranks running requests of
  over-quota tenants ahead of everyone else regardless of age.
* **End-to-end failure semantics** — a consumer that abandons its stream
  (client disconnect) triggers ``engine.cancel(rid)`` from the generator's
  ``finally``; :meth:`shutdown` (the SIGTERM path) drains gracefully,
  flushing in-flight streams while late submissions get a typed
  :class:`ShuttingDown`; per-request deadlines propagate through the
  engine's watch list; idle streams emit heartbeats so slow queues are
  distinguishable from dead connections.

Single-threaded by construction: asyncio's cooperative scheduling means
``submit``/``cancel`` can call the synchronous engine *directly* — the
driver task only runs ``engine.step()`` between ``await`` points, so there
is no interleaving hazard and no command queue.  Token events are built
incrementally from the engine's ``on_token`` callback, which fires with
per-token interpolated timestamps even inside a fused decode horizon.
"""
from __future__ import annotations

import asyncio
import json
import signal
from dataclasses import dataclass, field
from typing import AsyncIterator, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.faults import Overloaded, ShuttingDown
from repro_torch.serving.scheduler import Request, RequestState

__all__ = ["FrontDoor", "TokenBucket", "TokenEvent", "HeartbeatEvent",
           "DoneEvent", "run_server"]


# ---------------------------------------------------------------- events

@dataclass(frozen=True)
class TokenEvent:
    """One emitted token (tuple over codebooks) with its engine timestamp."""
    rid: int
    token: Tuple[int, ...]
    index: int                       # 0-based position in the generation
    t: float
    tenant: Optional[str] = None
    kind: str = field(default="token", init=False)


@dataclass(frozen=True)
class HeartbeatEvent:
    """Keep-alive for an idle stream (queued, swapped, or mid-horizon)."""
    rid: int
    t: float
    state: str
    kind: str = field(default="heartbeat", init=False)


@dataclass(frozen=True)
class DoneEvent:
    """Terminal event: exactly one per stream, always the last event."""
    rid: int
    t: float
    state: str                       # "done"/"timeout"/"cancelled"/"failed"
    finish_reason: Optional[str]
    n_tokens: int
    kind: str = field(default="done", init=False)


# ---------------------------------------------------------------- QoS

class TokenBucket:
    """Token-bucket quota metered on emitted tokens.

    ``debit`` may push the level negative: emission is billed *post hoc*
    (the engine already produced the token), so a deep speculative accept
    can overshoot.  The debt then delays re-admission — ``retry_after_s``
    sizes the wait to refill back past one token.
    """

    def __init__(self, rate: float, burst: float, now: float = 0.0):
        self.rate = float(rate)          # tokens/second refill
        self.burst = float(burst)        # level cap
        self.level = float(burst)
        self._t = float(now)

    def _refill(self, now: float) -> None:
        if now > self._t:
            self.level = min(self.burst, self.level + (now - self._t) * self.rate)
            self._t = now

    def debit(self, n: float, now: float) -> None:
        self._refill(now)
        self.level -= n

    def admit_ok(self, now: float) -> bool:
        self._refill(now)
        return self.level > 0.0

    def retry_after_s(self, now: float) -> float:
        self._refill(now)
        if self.level > 0.0:
            return 0.0
        return (1.0 - self.level) / max(self.rate, 1e-9)


class _Stream:
    """Per-request bridge between the driver and one consumer."""

    __slots__ = ("req", "queue", "emitted", "last_event_t")

    def __init__(self, req: Request):
        self.req = req
        # unbounded: depth is naturally capped by req.max_new + heartbeats
        self.queue: asyncio.Queue = asyncio.Queue()
        self.emitted = 0
        self.last_event_t = req.arrival


# ---------------------------------------------------------------- front door

class FrontDoor:
    """Asyncio serving layer over a synchronous :class:`ServingEngine`.

    Parameters
    ----------
    engine : ServingEngine
        The engine to drive.  The front door installs itself as the
        ``on_token`` callback (chaining any existing one) and as the
        scheduler's ``victim_key`` policy hook; :meth:`aclose` restores
        both, leaving the engine serviceable for direct use.
    max_queue : int
        Bound on the scheduler's waiting queue.  A submit that would
        exceed it raises :class:`Overloaded`.
    tenant_rate, tenant_burst : float, optional
        Token-bucket parameters applied per tenant id.  ``None`` disables
        quotas (untenanted deployments pay nothing).
    heartbeat_s : float, optional
        Emit a :class:`HeartbeatEvent` on any stream idle this long.
    """

    def __init__(self, engine, *, max_queue: int = 64,
                 tenant_rate: Optional[float] = None,
                 tenant_burst: Optional[float] = None,
                 heartbeat_s: Optional[float] = None):
        self.engine = engine
        self.max_queue = int(max_queue)
        self.tenant_rate = tenant_rate
        self.tenant_burst = tenant_burst if tenant_burst is not None else (
            tenant_rate if tenant_rate is not None else None)
        self.heartbeat_s = heartbeat_s
        self.buckets: Dict[str, TokenBucket] = {}
        self.stats = {"accepted": 0, "rejected_queue": 0,
                      "rejected_degrade": 0, "rejected_quota": 0,
                      "rejected_draining": 0, "disconnect_cancels": 0,
                      "heartbeats": 0}
        self._streams: Dict[int, _Stream] = {}
        self._done_mark = len(engine._done)
        self._draining = False
        self._wake = asyncio.Event()
        self._driver: Optional[asyncio.Task] = None
        self._closed = False
        # install hooks (chained / restored by aclose)
        self._prev_on_token = engine.on_token
        engine.on_token = self._on_token
        self._prev_victim_key = engine.sched.victim_key
        engine.sched.victim_key = self._victim_key

    # ---- engine hooks ---------------------------------------------------

    def _on_token(self, req: Request, tok, now: float) -> None:
        if self._prev_on_token is not None:
            self._prev_on_token(req, tok, now)
        if req.tenant is not None and self.tenant_rate is not None:
            self._bucket(req.tenant, now).debit(1.0, now)
        h = self._streams.get(req.rid)
        if h is None:
            return
        token = tuple(int(x) for x in np.asarray(tok).ravel().tolist())
        h.queue.put_nowait(TokenEvent(rid=req.rid, token=token,
                                      index=h.emitted, t=now,
                                      tenant=req.tenant))
        h.emitted += 1
        h.last_event_t = now

    def _victim_key(self, r: Request):
        # over-quota tenants preempt first, regardless of age; ties fall
        # back to the engine's default youngest-first policy
        return (1 if self._over_quota(r.tenant) else 0, r.arrival, r.rid)

    def _over_quota(self, tenant: Optional[str]) -> bool:
        if tenant is None or self.tenant_rate is None:
            return False
        b = self.buckets.get(tenant)
        return b is not None and b.level <= 0.0

    def _bucket(self, tenant: str, now: float) -> TokenBucket:
        b = self.buckets.get(tenant)
        if b is None:
            b = TokenBucket(self.tenant_rate, self.tenant_burst, now)
            self.buckets[tenant] = b
        return b

    # ---- admission ------------------------------------------------------

    def _reject(self, counter: str, exc: Exception, req: Request,
                now: float) -> Exception:
        self.stats[counter] += 1
        eng = self.engine
        if eng.tracer.enabled:
            args = {"rid": req.rid, "why": counter,
                    "retry_after": getattr(exc, "retry_after", None)}
            if req.tenant is not None:
                args["tenant"] = req.tenant
            eng.tracer.instant("reject", "lifecycle", "scheduler", ts=now,
                               args=args)
        return exc

    def submit(self, req: Request) -> AsyncIterator:
        """Admit ``req`` and return its async event stream.

        Raises :class:`Overloaded` (queue full / degradation denial /
        tenant over quota) or :class:`ShuttingDown` (draining) *at call
        time* — a rejected request never allocates engine state.  On
        success, ``req.arrival`` is stamped to the engine clock's *now*
        (front-door requests arrive when they are admitted; with greedy
        decoding the stream content depends only on the prompt, so this
        preserves bit-identical tokens vs. an offline run).
        """
        eng = self.engine
        now = eng._now()
        if self._draining or eng.draining or self._closed:
            raise self._reject(
                "rejected_draining",
                ShuttingDown(f"request {req.rid}: front door is draining"),
                req, now)
        if len(eng.sched.waiting) >= self.max_queue:
            # heuristic: one step per queued request ahead of this one
            step = max(eng._est_step_time(), 1e-3)
            raise self._reject(
                "rejected_queue",
                Overloaded(f"request {req.rid}: queue full "
                           f"({self.max_queue} waiting)",
                           retry_after=step * len(eng.sched.waiting),
                           tenant=req.tenant),
                req, now)
        ctl = eng.degrade
        if ctl is not None and ctl.deny_admission:
            raise self._reject(
                "rejected_degrade",
                Overloaded(f"request {req.rid}: degradation ladder at "
                           f"'{ctl.name}' denies admissions",
                           retry_after=max(0.0, ctl.retry_after(now) - now),
                           tenant=req.tenant),
                req, now)
        if req.tenant is not None and self.tenant_rate is not None:
            b = self._bucket(req.tenant, now)
            if not b.admit_ok(now):
                raise self._reject(
                    "rejected_quota",
                    Overloaded(f"request {req.rid}: tenant '{req.tenant}' "
                               f"over quota",
                               retry_after=b.retry_after_s(now),
                               tenant=req.tenant),
                    req, now)
        req.arrival = now
        h = _Stream(req)
        self._streams[req.rid] = h
        try:
            eng.submit(req)
        except Exception:
            self._streams.pop(req.rid, None)
            raise
        self.stats["accepted"] += 1
        self._wake.set()
        return self._consume(h)

    async def _consume(self, h: _Stream) -> AsyncIterator:
        req = h.req
        try:
            while True:
                ev = await h.queue.get()
                yield ev
                if ev.kind == "done":
                    return
        finally:
            # consumer abandoned the stream (disconnect, aclose, timeout
            # wrapper): cancel is idempotent, a no-op for terminal requests
            if not req.terminal:
                if self.engine.cancel(req.rid, reason="disconnect"):
                    self.stats["disconnect_cancels"] += 1
                self._wake.set()
            self._streams.pop(req.rid, None)

    # ---- driver ---------------------------------------------------------

    async def start(self) -> None:
        if self._driver is None:
            self._driver = asyncio.ensure_future(self._drive())

    async def _drive(self) -> None:
        eng = self.engine
        try:
            while not self._closed:
                if eng.sched.has_work:
                    eng.step()
                    self._route_done()
                    self._heartbeats()
                    # yield so consumers drain their queues between steps
                    await asyncio.sleep(0)
                else:
                    self._route_done()
                    self._wake.clear()
                    timeout = self.heartbeat_s if self.heartbeat_s else None
                    try:
                        await asyncio.wait_for(self._wake.wait(), timeout)
                    except asyncio.TimeoutError:
                        self._heartbeats(force_idle=True)
        except asyncio.CancelledError:
            pass

    def _route_done(self) -> None:
        """Push a DoneEvent for every newly-terminal request.

        Scans ``engine._done`` past a high-water mark, so requests that
        finished through *any* path — completion, deadline, queue timeout,
        client cancel, drain — all produce exactly one terminal event."""
        done = self.engine._done
        while self._done_mark < len(done):
            req = done[self._done_mark]
            self._done_mark += 1
            h = self._streams.get(req.rid)
            if h is None:
                continue
            t = req.t_done if req.t_done is not None else self.engine._now()
            h.queue.put_nowait(DoneEvent(
                rid=req.rid, t=t, state=req.state.value,
                finish_reason=req.finish_reason, n_tokens=req.n_generated))
            h.last_event_t = t

    def _heartbeats(self, force_idle: bool = False) -> None:
        if not self.heartbeat_s:
            return
        now = self.engine._now()
        for h in self._streams.values():
            if h.req.terminal:
                continue
            if h.queue.empty() and now - h.last_event_t >= self.heartbeat_s:
                h.queue.put_nowait(HeartbeatEvent(
                    rid=h.req.rid, t=now, state=h.req.state.value))
                h.last_event_t = now
                self.stats["heartbeats"] += 1

    # ---- shutdown -------------------------------------------------------

    async def shutdown(self) -> None:
        """Graceful SIGTERM semantics: stop admitting (late submits raise
        :class:`ShuttingDown`), cancel never-admitted queued requests with
        reason ``"drain"``, then step until every in-flight stream has
        flushed its terminal event."""
        eng = self.engine
        self._draining = True
        eng.draining = True
        now = eng._now()
        for _, _, req in list(eng.sched.waiting):
            if req.t_admit is None:
                eng.cancel(req.rid, reason="drain")
        self._route_done()
        await asyncio.sleep(0)
        while eng.sched.has_work:
            eng.step()
            self._route_done()
            await asyncio.sleep(0)
        self._route_done()
        # let consumers drain their final events before the driver stops
        for _ in range(3):
            await asyncio.sleep(0)
        await self.aclose()

    async def aclose(self) -> None:
        """Detach from the engine: stop the driver and restore the hooks.

        Unlike :meth:`shutdown` this does not drain — the engine stays
        serviceable for direct (synchronous) use afterwards."""
        if self._closed:
            return
        self._closed = True
        self._wake.set()
        if self._driver is not None:
            self._driver.cancel()
            try:
                await self._driver
            except asyncio.CancelledError:
                pass
            self._driver = None
        self.engine.on_token = self._prev_on_token
        self.engine.sched.victim_key = self._prev_victim_key

    def summary(self) -> Dict:
        out = dict(self.stats)
        out["live_streams"] = len(self._streams)
        if self.buckets:
            out["tenant_buckets"] = {
                t: round(b.level, 4) for t, b in sorted(self.buckets.items())}
        return out


# ---------------------------------------------------------------- HTTP/SSE

async def _read_request(reader) -> Tuple[str, str, Dict[str, str], bytes]:
    """Minimal HTTP/1.1 parse: request line, headers, Content-Length body."""
    line = await reader.readline()
    if not line:
        raise ConnectionError("empty request")
    parts = line.decode("latin-1").strip().split()
    if len(parts) < 2:
        raise ConnectionError(f"bad request line: {line!r}")
    method, path = parts[0], parts[1]
    headers: Dict[str, str] = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        k, _, v = line.decode("latin-1").partition(":")
        headers[k.strip().lower()] = v.strip()
    n = int(headers.get("content-length", "0") or "0")
    body = await reader.readexactly(n) if n else b""
    return method, path, headers, body


def _http_response(status: str, body: bytes,
                   extra_headers: Tuple[Tuple[str, str], ...] = ()) -> bytes:
    head = [f"HTTP/1.1 {status}", "Connection: close",
            f"Content-Length: {len(body)}",
            "Content-Type: application/json"]
    head += [f"{k}: {v}" for k, v in extra_headers]
    return ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body


def _event_json(ev) -> dict:
    if ev.kind == "token":
        return {"kind": "token", "rid": ev.rid, "token": list(ev.token),
                "index": ev.index, "t": round(ev.t, 6)}
    if ev.kind == "heartbeat":
        return {"kind": "heartbeat", "rid": ev.rid, "state": ev.state,
                "t": round(ev.t, 6)}
    return {"kind": "done", "rid": ev.rid, "state": ev.state,
            "finish_reason": ev.finish_reason, "n_tokens": ev.n_tokens,
            "t": round(ev.t, 6)}


async def run_server(fd: FrontDoor, host: str = "127.0.0.1",
                     port: int = 8080, *, vocab: int = 32000,
                     install_signals: bool = True,
                     ready: Optional[asyncio.Event] = None) -> None:
    """Serve ``POST /generate`` as a server-sent-event token stream.

    Request body (JSON): ``{"prompt": [ids]}`` or ``{"prompt_len": n}``
    (random prompt), plus optional ``max_new``, ``tenant``, and
    ``deadline_ms``.  Responses: ``200`` SSE stream of token/heartbeat/done
    events; ``429`` + ``Retry-After`` on :class:`Overloaded`; ``503`` on
    :class:`ShuttingDown`.  SIGTERM/SIGINT trigger :meth:`FrontDoor.\
    shutdown` — in-flight streams flush, late submits get ``503``.
    """
    await fd.start()
    next_rid = [max(fd.engine._by_rid.keys(), default=-1) + 1]
    stop = asyncio.Event()

    async def handle(reader, writer):
        try:
            try:
                method, path, headers, body = await _read_request(reader)
            except (ConnectionError, asyncio.IncompleteReadError):
                return
            if method != "POST" or path != "/generate":
                writer.write(_http_response(
                    "404 Not Found", b'{"error": "POST /generate"}'))
                await writer.drain()
                return
            try:
                spec = json.loads(body or b"{}")
            except json.JSONDecodeError:
                writer.write(_http_response(
                    "400 Bad Request", b'{"error": "invalid JSON"}'))
                await writer.drain()
                return
            if "prompt" in spec:
                prompt = np.asarray(spec["prompt"], dtype=np.int32)
            else:
                n = int(spec.get("prompt_len", 16))
                rng = np.random.default_rng(next_rid[0])
                prompt = rng.integers(0, vocab, size=(n,), dtype=np.int32)
            req = Request(rid=next_rid[0], prompt=prompt,
                          max_new=int(spec.get("max_new", 16)),
                          arrival=0.0, tenant=spec.get("tenant"))
            next_rid[0] += 1
            if spec.get("deadline_ms") is not None:
                req.deadline = (fd.engine._now()
                                + float(spec["deadline_ms"]) / 1e3)
            try:
                stream = fd.submit(req)
            except ShuttingDown as e:
                writer.write(_http_response(
                    "503 Service Unavailable",
                    json.dumps({"error": str(e)}).encode()))
                await writer.drain()
                return
            except Overloaded as e:
                retry = e.retry_after if e.retry_after is not None else 1.0
                writer.write(_http_response(
                    "429 Too Many Requests",
                    json.dumps({"error": str(e),
                                "retry_after": retry}).encode(),
                    (("Retry-After", f"{max(0.0, retry):.3f}"),)))
                await writer.drain()
                return
            writer.write(b"HTTP/1.1 200 OK\r\n"
                         b"Content-Type: text/event-stream\r\n"
                         b"Cache-Control: no-cache\r\n"
                         b"Connection: close\r\n\r\n")
            await writer.drain()
            async for ev in stream:
                payload = json.dumps(_event_json(ev))
                writer.write(f"data: {payload}\n\n".encode())
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            pass                     # client went away; finally-cancel fires
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    server = await asyncio.start_server(handle, host, port)

    def _sigterm():
        stop.set()

    loop = asyncio.get_event_loop()
    if install_signals:
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                loop.add_signal_handler(sig, _sigterm)
            except (NotImplementedError, RuntimeError):
                pass                 # non-main thread / platform without it
    if ready is not None:
        ready.set()
    try:
        await stop.wait()
    finally:
        server.close()
        await server.wait_closed()
        await fd.shutdown()
