"""Request lifecycle + slot-based continuous-batching scheduler.

State machine (per request)::

    QUEUED ──admit──▶ RUNNING ──complete──▶ DONE
       ▲                │  ▲
       │   recompute-   │  │ resume (swap-in)
       └── preempt ─────┤  │
                        └──┴── swap preempt ──▶ SWAPPED

    QUEUED / RUNNING / SWAPPED ──release──▶ TIMEOUT | CANCELLED | FAILED

Every request ends in exactly one terminal state: ``DONE`` (eos/length),
``TIMEOUT`` (deadline or queue timeout expired), ``CANCELLED`` (client
cancel or drain), or ``FAILED`` (quarantined by a fault guard).  The
typed reason lands in ``Request.finish_reason``.  :meth:`Scheduler.release`
tears a live request down from any non-terminal state — slot freed,
refcount claims dropped, swap tickets returned — reusing the
recompute-downgrade release discipline, so the pool/prefix-cache stay
coherent no matter where in the lifecycle the request dies.

``Scheduler.plan(now)`` is pure bookkeeping — it mutates only scheduler /
request accounting state and returns a :class:`StepPlan` of device actions
(swap-out scatters, swap-in gathers, chunked prefills) for the engine to
execute.  That split keeps the policy unit-testable without touching the device.

Per step, in order:

1. **Growth** — each running request whose next decode write crosses a block
   boundary allocates one more block.  On pool exhaustion the youngest
   running request is preempted (swap if the swap tier has room, else
   recompute-requeue) until the allocation succeeds; a request may preempt
   itself, in which case it stops growing.
2. **Resume** — swapped requests re-enter freed slots (FIFO), ahead of new
   admissions so preempted work cannot starve.
3. **Admission** — arrived queued requests fill the remaining free slots,
   each allocating blocks for its whole prompt (+ the first decode row).

Steps 2–3 are skipped on any step that preempted, so blocks freed under
memory pressure relieve the pressure instead of thrashing.

For horizon-batched decode the engine follows ``plan`` with
:meth:`Scheduler.grant_horizon`, which returns the largest safe number of
lockstep decode steps for one fused dispatch and pre-extends every running
block table to cover it (see the method docstring for the three caps).
``table_version`` increments on every block-table/slot mutation so the
engine's device mirror of the tables re-uploads only when something changed.

**Prefix sharing.**  With a :class:`PrefixCache` attached, admission matches
the incoming request's prompt against resident block chains at block
granularity: matched full blocks are *aliased* into the new table (refcount
bump, zero prefill work), a partially-matching block is COW-forked (the
engine copies it before the slot writes its tail into it), and only the
unmatched tail is prefilled — the admission allocates the **marginal** new
blocks, not the full prompt footprint.  The cache holds one claim per
registered block, so prompt blocks of completed/preempted requests stay
resident (system-prompt caching) until allocation pressure evicts them LRU
through the pool's reclaimer hook.  ``free``/preemption decrement refcounts,
so a block shared with another slot (or retained by the cache) is never
physically released while still read.
"""
from __future__ import annotations

import enum
import heapq
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.blocks import BlockPool
from repro_torch.serving.trace import NULL_TRACER

__all__ = ["PrefixCache", "PrefixGrant", "Request", "RequestState",
           "Scheduler", "StepPlan", "TERMINAL_STATES"]


class RequestState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    SWAPPED = "swapped"
    DONE = "done"
    TIMEOUT = "timeout"
    CANCELLED = "cancelled"
    FAILED = "failed"


#: states a request can never leave
TERMINAL_STATES = (RequestState.DONE, RequestState.TIMEOUT,
                   RequestState.CANCELLED, RequestState.FAILED)


@dataclass
class Request:
    """One serving request: a prompt and a generation budget.

    ``prompt`` is an int32 array of shape [S] (or [K, S] for multi-codebook
    models).  ``extras`` may carry ``patch_embeds``/``pos3d`` for vision-stub
    models (single-chunk prompts only).  All fields below ``arrival`` are
    runtime state owned by the scheduler/engine.
    """

    rid: int
    prompt: np.ndarray
    max_new: int
    arrival: float = 0.0
    extras: Optional[dict] = None
    # multi-tenant QoS identity: threaded through lifecycle/decision trace
    # events, per-request ODIN bills and the windowed per-tenant TTFT/TPOT
    # metrics; None ⇒ untenanted (single-tenant deployments pay nothing)
    tenant: Optional[str] = None
    # absolute engine-clock instant after which the request times out (None
    # ⇒ no deadline); queue_timeout is relative to arrival and applies only
    # while the request has never been admitted (t_admit is None); cancel_at
    # is an absolute scripted client cancellation (workload schedules)
    deadline: Optional[float] = None
    queue_timeout: Optional[float] = None
    cancel_at: Optional[float] = None

    state: RequestState = RequestState.QUEUED
    finish_reason: Optional[str] = None   # "eos"/"length"/"deadline"/"queue"/
                                          # "client"/"drain"/"nan_logits"/...
    slot: int = -1
    generated: List = field(default_factory=list)
    block_table: List[int] = field(default_factory=list)
    # device blocks a swap preemption kept claims on (sharing-aware swap:
    # blocks other tables/the prefix cache also hold stay resident instead of
    # round-tripping through the swap tier; resume re-attaches them), and the
    # swap-tier blocks its ticket occupies (scheduler-side accounting so a
    # stuck resume can be downgraded to recompute without engine help)
    kept_blocks: List[int] = field(default_factory=list)
    swap_block_ids: List[int] = field(default_factory=list)
    eos: bool = False                     # emitted the engine's eos_id
    ticket: object = None                 # SwapTicket while SWAPPED
    # mixed-dispatch prefill progress: while ``prefilling`` the request's
    # prompt replay is being staged through fused mixed dispatches and
    # ``prefill_pos`` counts the replay rows already written (admission
    # starts it at the prefix grant's ``start``).  The separate prefill
    # path completes in one engine call and never sets ``prefilling``.
    prefilling: bool = False
    prefill_pos: int = 0
    n_prefill_tokens: int = 0             # includes recompute re-prefills
    spec_overhead_rows: int = 0           # verify rows beyond emitted tokens
    n_preempt_swap: int = 0
    n_preempt_recompute: int = 0
    t_admit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[-1])

    @property
    def n_generated(self) -> int:
        return len(self.generated)

    @property
    def cached_len(self) -> int:
        """Cache rows this request occupies: prompt + all generated tokens
        except the pending one (the last generated token is the next decode
        *input*; its KV row is written by that decode step)."""
        return self.prompt_len + max(0, self.n_generated - 1)

    @property
    def remaining(self) -> int:
        """Decode budget left: tokens this request may still emit."""
        return max(0, self.max_new - self.n_generated)

    @property
    def done(self) -> bool:
        return self.eos or self.n_generated >= self.max_new

    @property
    def terminal(self) -> bool:
        return self.state in TERMINAL_STATES

    def replay_tokens(self) -> np.ndarray:
        """Tokens a (re-)prefill of this request feeds the model: the prompt
        plus every generated token except the pending one (whose KV row is
        written by its own decode step).  Shape [.., cached_len]."""
        prompt = np.asarray(self.prompt)
        if self.n_generated <= 1:
            return prompt
        gen = np.stack(self.generated[:-1], axis=-1).astype(np.int32)
        return np.concatenate([prompt, gen.reshape(*prompt.shape[:-1], -1)],
                              axis=-1)


@dataclass
class PrefixGrant:
    """Shared-prefix admission grant for one request.

    ``start`` cache rows are already resident through the request's block
    table — the engine prefills only ``[start:]`` of the replay tokens.
    ``shared_blocks`` leading table entries are aliased (refcounted) blocks;
    ``fork`` is a ``(src, dst)`` pool-block copy the engine must execute
    *before* the tail prefill (the COW fork of a partially-matched block —
    rows below ``start % block_size`` of ``dst`` become the copied prefix
    rows, and the slot's own writes land at ``start`` onward).
    """

    start: int
    shared_blocks: int
    fork: Optional[Tuple[int, int]] = None


@dataclass
class StepPlan:
    """Device actions for one engine step.

    ``preempt`` entries are ``(request, mode, swap_block_ids, old_slot,
    dev_block_ids)`` with mode "swap" (engine copies the request's device KV
    blocks — ``dev_block_ids``, its block table at preemption time — into the
    listed swap blocks) or "recompute" (nothing device-side; the request
    re-prefills on readmission).  The device ids are snapshot *before* the
    pool frees them; the engine's swap-out copy runs before anything written
    this step (growth/prefill lands in the decode phase), so the handoff is
    race-free within the step.  ``resume``/``admit`` requests already have
    their new slot and device block table assigned.  ``grants`` maps an
    admitted request's rid to its :class:`PrefixGrant` (absent ⇒ full
    prefill from row 0).
    """

    preempt: List[Tuple[Request, str, Optional[List[int]], int, List[int]]] = field(default_factory=list)
    resume: List[Request] = field(default_factory=list)
    admit: List[Request] = field(default_factory=list)
    grants: Dict[int, PrefixGrant] = field(default_factory=dict)


class _PrefixNode:
    """One resident block of a registered prompt chain."""

    __slots__ = ("key", "parent", "block_id", "tokens", "stamp")

    def __init__(self, key: int, parent: int, block_id: int,
                 tokens: np.ndarray, stamp: int):
        self.key = key
        self.parent = parent
        self.block_id = block_id
        self.tokens = tokens          # [.., t] prompt tokens held by the block
        self.stamp = stamp            # LRU clock of the last match/registration


class PrefixCache:
    """Prompt-prefix trie over resident pool blocks (block granularity).

    Chain keys hash the *path* of block contents from the prompt start
    (``key_i = hash(key_{i-1}, tokens_i)``), so a lookup walks the incoming
    prompt block by block with O(1) dict probes; a final scan of the matched
    node's children finds the longest partial-block match (the COW-fork
    case), comparing actual tokens — never hashes — so a hash collision can
    at worst miss a share, not corrupt one.

    Every registered node holds **one pool claim** on its block
    (``pool.share``): prompt blocks survive their request's completion or
    preemption and are evicted LRU only when allocation pressure asks for
    them back through the pool's reclaimer hook (``reclaimable``/``reclaim``
    — only nodes whose block has no other claim are evictable, since
    releasing a block some table still reads would free nothing and lose the
    entry).  Node contents are immutable by construction: tables never write
    a row into a block another table aliases (prefill/decode writes always
    land at or beyond the grant's ``start``), and a node's ``tokens`` cover
    only the prompt rows its owner wrote before registration.
    """

    _ROOT = 0

    def __init__(self, pool: BlockPool, block_size: int):
        self.pool = pool
        self.block_size = block_size
        self._nodes: Dict[int, _PrefixNode] = {}     # chain key → node
        self._by_block: Dict[int, int] = {}          # block id → chain key
        self._children: Dict[int, List[int]] = {}    # parent key → child keys
        self._clock = 0
        self.hit_tokens = 0
        self.forks = 0
        pool.reclaimer = self

    # -- reclaimer protocol (BlockPool) -------------------------------------

    def reclaimable(self) -> int:
        return sum(1 for n in self._nodes.values()
                   if self.pool.refs(n.block_id) == 1)

    def reclaim(self, n: int) -> int:
        """Evict up to ``n`` LRU nodes whose block only the cache holds.

        Leaf-first: a chain's nodes share LRU stamps root-to-leaf, so a pure
        min-stamp pick would evict the *root* and strand every still-resident
        descendant unmatchable.  Preferring childless nodes shortens chains
        from the tail, keeping the surviving prefix usable.  (Both scans are
        O(cached nodes) — fine at serving scale; an evictability index is
        the lever if caches ever grow to many thousands of blocks.)
        """
        freed = 0
        while freed < n:
            victim = fallback = None
            for node in self._nodes.values():
                if self.pool.refs(node.block_id) != 1:
                    continue
                if self._children.get(node.key):
                    if fallback is None or node.stamp < fallback.stamp:
                        fallback = node
                elif victim is None or node.stamp < victim.stamp:
                    victim = node
            victim = victim or fallback
            if victim is None:
                break
            self._evict(victim)
            freed += 1
        return freed

    def _evict(self, node: _PrefixNode) -> None:
        tracer = self.pool.tracer
        if tracer.enabled:
            tracer.instant("prefix-evict", "pool", "pool",
                           args={"block": node.block_id,
                                 "tokens": int(node.tokens.shape[-1])})
        del self._nodes[node.key]
        del self._by_block[node.block_id]
        kids = self._children.get(node.parent)
        if kids is not None:
            kids.remove(node.key)
            if not kids:
                del self._children[node.parent]
        self.pool.free([node.block_id])

    # -- queries ------------------------------------------------------------

    def holds(self, bid: int) -> bool:
        return bid in self._by_block

    def held_blocks(self) -> List[int]:
        return list(self._by_block)

    def __len__(self) -> int:
        return len(self._nodes)

    # -- matching / registration --------------------------------------------

    @staticmethod
    def _key(parent: int, chunk: np.ndarray) -> int:
        return hash((parent, chunk.shape[-1], chunk.tobytes()))

    def _tick(self, node: _PrefixNode) -> None:
        self._clock += 1
        node.stamp = self._clock

    def match(self, toks: np.ndarray, limit: int
              ) -> Tuple[List[int], int, Optional[int]]:
        """Longest resident prefix of ``toks`` (int array, [.., S]).

        Returns ``(full_block_ids, partial_tokens, partial_src_block)``: the
        aliasable full blocks, then the longest common prefix (< block) with
        any resident continuation block — the COW-fork source.  At most
        ``limit`` tokens ever match, so the caller always keeps ≥ 1 tail
        token to prefill (the logits that mint the next token).
        """
        bs = self.block_size
        ids: List[int] = []
        parent = self._ROOT
        while (len(ids) + 1) * bs <= min(toks.shape[-1], limit):
            chunk = toks[..., len(ids) * bs:(len(ids) + 1) * bs]
            node = self._nodes.get(self._key(parent, chunk))
            if node is None or not np.array_equal(node.tokens, chunk):
                break
            self._tick(node)
            ids.append(node.block_id)
            parent = node.key
        off = len(ids) * bs
        best_p, best_node = 0, None
        cap = min(toks.shape[-1], limit) - off
        if cap > 0:
            for ck in self._children.get(parent, ()):
                node = self._nodes[ck]
                n = min(node.tokens.shape[-1], cap)
                if n <= best_p:
                    continue
                eq = (node.tokens[..., :n] == toks[..., off:off + n])
                col = eq.reshape(-1, n).all(axis=0)
                p = int(col.sum()) if col.all() else int(np.argmin(col))
                if p > best_p:
                    best_p, best_node = p, node
        if best_node is not None:
            self._tick(best_node)
        return ids, best_p, best_node.block_id if best_node else None

    def register(self, req: Request) -> None:
        """Index the request's *prompt* blocks (full chain + partial tail).

        Already-present chains are skipped (aliased blocks re-register as
        no-ops); each newly indexed block gains the cache's claim.
        """
        toks = np.asarray(req.prompt)
        bs = self.block_size
        S = toks.shape[-1]
        parent = self._ROOT
        for j in range(S // bs):
            chunk = toks[..., j * bs:(j + 1) * bs]
            key = self._key(parent, chunk)
            node = self._nodes.get(key)
            if node is None or not np.array_equal(node.tokens, chunk):
                if node is not None:       # hash collision: keep the old node
                    break
                node = self._insert(key, parent, req.block_table[j], chunk)
            parent = key
        p = S % bs
        if p:
            chunk = toks[..., S - p:]
            key = self._key(parent, chunk)
            node = self._nodes.get(key)
            if node is None:
                self._insert(key, parent, req.block_table[S // bs], chunk)

    def _insert(self, key: int, parent: int, bid: int,
                chunk: np.ndarray) -> _PrefixNode:
        if bid in self._by_block:          # block already indexed (aliased)
            return self._nodes[self._by_block[bid]]
        self.pool.share([bid])
        self._clock += 1
        node = _PrefixNode(key, parent, bid, np.array(chunk), self._clock)
        self._nodes[key] = node
        self._by_block[bid] = key
        self._children.setdefault(parent, []).append(key)
        return node


class Scheduler:
    def __init__(self, n_slots: int, pool: BlockPool, max_len: int,
                 swap_pool: Optional[BlockPool] = None,
                 prefix_cache: Optional[PrefixCache] = None,
                 write_span: int = 1):
        self.n_slots = n_slots
        self.pool = pool
        self.max_len = max_len
        self.swap_pool = swap_pool
        self.prefix_cache = prefix_cache
        # structured-event recorder (repro_torch.serving.trace); the engine swaps
        # in its Tracer — the no-op default keeps every emit site free
        self.tracer = NULL_TRACER
        # rows one decode dispatch may write per slot before rollback:
        # 1 + the engine's speculative draft length (K)
        self.write_span = write_span
        self.waiting: List[Tuple[float, int, Request]] = []    # heap
        self.swapped: deque = deque()
        self.running: Dict[int, Request] = {}                  # slot → request
        self.free_slots: List[int] = list(range(n_slots - 1, -1, -1))
        # bumped whenever any request's block table (or slot binding) changes;
        # the engine re-mirrors its device table array only when this moves
        self.table_version: int = 0
        # degradation knobs (set each step by the engine's controller):
        # admission_hold, when not None, pauses admissions and carries the
        # structured retry-after instant for denied clients; prefix_retain
        # False stops registering new prompt chains (retention released)
        self.admission_hold: Optional[float] = None
        self.prefix_retain: bool = True
        # mixed dispatch (engine-owned): defer prompt-chain registration to
        # finish_prefill — registering at admission would let a later arrival
        # alias blocks whose rows the staged prefill has not written yet
        self.defer_prefix_register: bool = False
        # round-robin cursor for decode rows under mixed-budget scarcity
        self._mixed_rr: int = 0
        # preemption-victim policy hook: a key function over running requests
        # (max wins).  None keeps the default youngest-first ``(arrival,
        # rid)`` order; the front door installs a QoS-aware key that ranks
        # over-quota tenants ahead of everyone regardless of age.
        self.victim_key: Optional[callable] = None

    # -- queries ------------------------------------------------------------

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.swapped or self.running)

    def next_arrival(self) -> Optional[float]:
        return self.waiting[0][0] if self.waiting else None

    # -- lifecycle ----------------------------------------------------------

    def submit(self, req: Request) -> None:
        total = req.prompt_len + req.max_new
        if total > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt+max_new = {total} exceeds max_len {self.max_len}")
        if self.pool.blocks_for(total) > self.pool.usable_blocks:
            raise ValueError(
                f"request {req.rid}: needs {self.pool.blocks_for(total)} blocks, "
                f"pool has {self.pool.usable_blocks} usable")
        if req.max_new < 1:
            raise ValueError(f"request {req.rid}: max_new must be >= 1")
        heapq.heappush(self.waiting, (req.arrival, req.rid, req))

    def complete(self, req: Request, now: float) -> None:
        """Called by the engine when the request's last token was emitted."""
        self.pool.free(req.block_table)
        req.block_table = []
        self.running.pop(req.slot)
        self.free_slots.append(req.slot)
        req.slot = -1
        req.state = RequestState.DONE
        req.finish_reason = "eos" if req.eos else "length"
        req.t_done = now
        self.table_version += 1

    def release(self, req: Request, state: RequestState, now: float,
                reason: str) -> None:
        """Tear a live request down into terminal ``state`` from wherever it
        is in the lifecycle, dropping every resource claim it holds:

        * RUNNING — free the block table (refcount-aware: shared/cached
          blocks survive), free the slot;
        * SWAPPED — drop kept-prefix claims, return swap-tier blocks and the
          ticket (the recompute-downgrade release discipline);
        * QUEUED — remove from the waiting heap.

        The engine owns the trace emission; this is pure bookkeeping."""
        if req.terminal:
            return
        if req.state is RequestState.RUNNING:
            self.pool.free(req.block_table)
            req.block_table = []
            self.running.pop(req.slot)
            self.free_slots.append(req.slot)
            req.slot = -1
            self.table_version += 1
        elif req.state is RequestState.SWAPPED:
            self.swapped.remove(req)
            self.pool.free(req.kept_blocks)
            req.kept_blocks = []
            if self.swap_pool is not None and req.swap_block_ids:
                self.swap_pool.free(req.swap_block_ids)
            req.swap_block_ids = []
            req.ticket = None
        else:                               # QUEUED: drop the heap entry
            self.waiting = [e for e in self.waiting if e[2] is not req]
            heapq.heapify(self.waiting)
        req.state = state
        req.finish_reason = reason
        req.t_done = now

    # -- PCRAM bad-block retirement -----------------------------------------

    def retire_blocks(self, bad: List[int]) -> List[Tuple[int, int]]:
        """Retire bad device blocks, remapping every live claim.

        For each block: free → pulled straight off the free list; held only
        by the prefix cache → the cached chain node is evicted first (its
        content is reconstructible from tokens, no copy owed); referenced →
        a replacement block is allocated, the refcount claims transfer, and
        every holder (running block tables, swapped requests' kept-prefix
        claims, the prefix-cache node) is remapped to the replacement.

        Returns ``(old, new)`` pairs whose *contents the caller must copy*
        on the physical store before the next dispatch reads them — called
        by the engine's reliability sweep ahead of ``plan()``, so no
        dispatch is in flight while ids move.  A referenced block with no
        replacement available is left live (not retired); the caller retries
        on a later sweep once pressure clears.

        The returned pairs are safe to apply as ONE batched copy: free bad
        blocks are retired first (so they can never be handed out as a
        replacement), and a bad block that still ends up as a replacement
        destination (cache eviction inside ``retire_used``'s alloc can
        re-free one mid-loop) is deferred to a later call instead of being
        retired now — a chained ``a→b, b→c`` copy in a single scatter would
        hand ``c`` the *old* bytes of ``b``.
        """
        cache = self.prefix_cache
        copies: List[Tuple[int, int]] = []
        remapped = False
        # pass 1: unreferenced (and cache-only) bad blocks leave the free
        # list before any replacement allocation can pick them up
        deferred = []
        for bid in bad:
            if bid in self.pool.retired:
                continue
            refs = self.pool.refs(bid)
            if refs == 0:
                self.pool.retire_free(bid)
            elif cache is not None and cache.holds(bid) and refs == 1:
                # cache-only claim: evict (frees the block), then retire —
                # the chain rebuilds from tokens on the next matching prompt
                cache._evict(cache._nodes[cache._by_block[bid]])
                self.pool.retire_free(bid)
            else:
                deferred.append(bid)
        # pass 2: referenced bad blocks drain through a replacement
        dsts: set = set()
        for bid in deferred:
            if bid in dsts:
                continue                    # became a replacement: next sweep
            if self.pool.refs(bid) == 0:
                # lost its claims mid-loop (eviction re-freed it)
                self.pool.retire_free(bid)
                continue
            new = self.pool.retire_used(bid)
            if new is None:
                continue                    # no replacement yet: retry later
            dsts.add(new)
            for req in self.running.values():
                for i, b in enumerate(req.block_table):
                    if b == bid:
                        req.block_table[i] = new
                        remapped = True
            for req in self.swapped:
                for i, b in enumerate(req.kept_blocks):
                    if b == bid:
                        req.kept_blocks[i] = new
                        remapped = True
            if cache is not None and cache.holds(bid):
                key = cache._by_block.pop(bid)
                cache._by_block[new] = key
                cache._nodes[key].block_id = new
            copies.append((bid, new))
        if remapped or copies:
            self.table_version += 1
        return copies

    # -- planning -----------------------------------------------------------

    def _victim(self) -> Optional[Request]:
        """Preemption victim: youngest running request (latest arrival breaks
        toward higher rid), unless a ``victim_key`` policy hook reorders."""
        if not self.running:
            return None
        key = self.victim_key or (lambda r: (r.arrival, r.rid))
        return max(self.running.values(), key=key)

    def _kept_prefix(self, req: Request) -> int:
        """Leading device blocks a swap preemption may keep claims on: fully
        written blocks (strictly below the next write row) that some *other*
        claim also holds — another table's alias or the prefix cache.  Those
        blocks would not be physically freed by our release anyway, so
        keeping our claim costs nothing now and saves both the swap-tier copy
        and the swap-in restore; content stays valid because aliased blocks
        are never written (write-block exclusivity)."""
        if self.prefix_cache is None:
            return 0
        kept = 0
        limit = min(req.cached_len // self.pool.block_size,
                    len(req.block_table))
        while kept < limit and self.pool.refs(req.block_table[kept]) >= 2:
            kept += 1
        return kept

    def _preempt(self, req: Request, plan: StepPlan) -> None:
        old_slot = req.slot
        self.running.pop(old_slot)
        self.free_slots.append(old_slot)
        req.slot = -1
        dev_ids = list(req.block_table)     # snapshot for the swap-out copy
        swap_ids = None
        kept = 0
        # a mid-prefill request has written only ``prefill_pos`` of its
        # ``cached_len`` rows — a swap-out would copy (and a resume restore)
        # garbage for the unwritten tail, so force recompute instead
        if self.swap_pool is not None and not req.prefilling:
            kept = self._kept_prefix(req)
            swap_ids = self.swap_pool.alloc(
                self.swap_pool.blocks_for(req.cached_len) - kept)
        if swap_ids is not None:
            req.kept_blocks = dev_ids[:kept]
            req.swap_block_ids = list(swap_ids)
            self.pool.free(dev_ids[kept:])  # shared prefix claims stay held
            req.block_table = []
            self.table_version += 1
            req.state = RequestState.SWAPPED
            req.n_preempt_swap += 1
            self.swapped.append(req)
            plan.preempt.append((req, "swap", swap_ids, old_slot, dev_ids))
        else:
            self.pool.free(dev_ids)
            req.block_table = []
            self.table_version += 1
            req.state = RequestState.QUEUED
            req.n_preempt_recompute += 1
            req.prefilling = False
            req.prefill_pos = 0
            heapq.heappush(self.waiting, (req.arrival, req.rid, req))
            plan.preempt.append((req, "recompute", None, old_slot, dev_ids))
        if self.tracer.enabled:
            mode = "swap" if swap_ids is not None else "recompute"
            args = {"rid": req.rid, "slot": old_slot, "mode": mode,
                    "blocks": len(dev_ids), "kept_blocks": kept}
            if req.tenant is not None:
                args["tenant"] = req.tenant
            self.tracer.instant(f"preempt-{mode}", "scheduler", "scheduler",
                                args=args, flow=req.rid)

    def _downgrade_to_recompute(self, req: Request) -> None:
        """Convert a swapped request that can never resume (pool fragmented
        by retained claims, nothing running) into a recompute readmission:
        release its kept claims and swap-tier blocks, drop the ticket, and
        requeue — the re-prefill rebuilds the KV from tokens (and typically
        re-attaches whatever prefix chains survived)."""
        self.pool.free(req.kept_blocks)
        req.kept_blocks = []
        if self.swap_pool is not None and req.swap_block_ids:
            self.swap_pool.free(req.swap_block_ids)
        req.swap_block_ids = []
        req.ticket = None
        req.state = RequestState.QUEUED
        req.n_preempt_recompute += 1
        heapq.heappush(self.waiting, (req.arrival, req.rid, req))
        if self.tracer.enabled:
            self.tracer.instant("swap-downgrade", "scheduler", "scheduler",
                                args={"rid": req.rid}, flow=req.rid)

    def fail_swap_out(self, req: Request) -> None:
        """The swap-out copy failed after :meth:`_preempt` moved the request
        to SWAPPED (ticket never created).  Downgrade to recompute: kept
        claims and swap-tier blocks are released, the request re-prefills
        from tokens on readmission.  Nothing device-side was written, so the
        caches are untouched."""
        self.swapped.remove(req)
        self._downgrade_to_recompute(req)

    def fail_resume(self, req: Request) -> None:
        """The swap-in copy failed after :meth:`plan` placed the resumed
        request back in a slot (functional swap-in: the caches are
        untouched).  Tear the placement back down and requeue as recompute —
        the swap-tier copy may be suspect, so its blocks are returned rather
        than retried."""
        self.pool.free(req.block_table)
        req.block_table = []
        self.running.pop(req.slot)
        self.free_slots.append(req.slot)
        req.slot = -1
        self.table_version += 1
        if self.swap_pool is not None and req.ticket is not None:
            self.swap_pool.free(req.ticket.block_ids)
        req.ticket = None
        req.swap_block_ids = []
        req.state = RequestState.QUEUED
        req.n_preempt_recompute += 1
        heapq.heappush(self.waiting, (req.arrival, req.rid, req))
        if self.tracer.enabled:
            self.tracer.instant("resume-fail", "scheduler", "scheduler",
                                args={"rid": req.rid}, flow=req.rid)

    def _place(self, req: Request, blocks: List[int], now: float) -> None:
        req.block_table = blocks
        req.slot = self.free_slots.pop()
        req.state = RequestState.RUNNING
        self.running[req.slot] = req
        self.table_version += 1
        if req.t_admit is None:
            req.t_admit = now

    def _check_write_block(self, req: Request) -> None:
        """Every block the request's next decode dispatch may write — rows
        ``cached_len .. cached_len + write_span - 1`` (span > 1 under
        speculative verify, whose rejected rows roll back) — must be
        table-exclusive: aliased by no other table, at most retained by the
        prefix cache.  A violation means a COW fork was missed; fail loudly
        here instead of silently corrupting a shared prefix.  Blocks past the
        table's current length are skipped (horizon pre-extension allocates
        them fresh and exclusive before any multi-row dispatch runs)."""
        bs = self.pool.block_size
        first = req.cached_len // bs
        last = (req.cached_len + self.write_span - 1) // bs
        for idx in range(first, last + 1):
            if idx >= len(req.block_table):
                return                      # not allocated yet / preempted
            bid = req.block_table[idx]
            refs = self.pool.refs(bid)
            if self.prefix_cache is not None and self.prefix_cache.holds(bid):
                refs -= 1
            if refs != 1:
                raise RuntimeError(
                    f"request {req.rid}: decode write rows "
                    f"[{req.cached_len}, {req.cached_len + self.write_span}) "
                    f"land in block {bid} carrying {refs} table claims — "
                    f"missed COW fork would corrupt a shared prefix")

    def _admission_blocks(self, req: Request
                          ) -> Tuple[Optional[List[int]], Optional[PrefixGrant]]:
        """Block table for an admission: aliased shared-prefix blocks (+ one
        COW fork) plus freshly allocated *marginal* blocks.  None ⇒ the pool
        cannot cover the marginal need (claims rolled back, nothing leaked).
        """
        need = self.pool.blocks_for(req.cached_len + 1)
        if self.prefix_cache is not None and not req.extras:
            toks = req.replay_tokens()
            ids, p, src = self.prefix_cache.match(toks, limit=toks.shape[-1] - 1)
            if (ids or p) and self.pool.available_blocks < need - len(ids):
                # cannot cover the marginal need even with eviction: bail
                # before touching any claims, so a stalled head-of-queue
                # request retried every step neither churns fork blocks nor
                # evicts resident chains for nothing
                return None, None
            if ids or p:
                self.pool.share(ids)
                table = list(ids)
                fork = None
                if p:
                    self.pool.share([src])
                    dst = self.pool.fork(src)
                    if dst is None:        # exhausted mid-fork: roll back
                        self.pool.free([src])
                        self.pool.free(ids)
                        return None, None
                    table.append(dst)
                    fork = (src, dst)
                got = self.pool.alloc(need - len(table))
                if got is None:            # marginal blocks unavailable
                    self.pool.free(table[len(ids):])   # the fork block
                    self.pool.free(ids)
                    return None, None
                table += got
                # cache hit/fork accounting only on *placed* admissions
                self.prefix_cache.hit_tokens += len(ids) * self.pool.block_size + p
                if fork is not None:
                    self.prefix_cache.forks += 1
                grant = PrefixGrant(start=len(ids) * self.pool.block_size + p,
                                    shared_blocks=len(ids), fork=fork)
                return table, grant
        got = self.pool.alloc(need)
        return (got, None) if got is not None else (None, None)

    def plan(self, now: float) -> StepPlan:
        plan = StepPlan()

        # 1. growth, oldest first: the next decode step writes KV row
        # ``cached_len``, which may need a fresh block.
        for req in sorted(self.running.values(), key=lambda r: (r.arrival, r.rid)):
            if req.slot < 0:               # already preempted this step
                continue
            grew = len(req.block_table)
            while not self.pool.extend_to(req.block_table, req.cached_len + 1):
                victim = self._victim()
                self._preempt(victim, plan)
                if victim is req:
                    break
            if len(req.block_table) != grew:
                self.table_version += 1
            if req.slot >= 0:
                self._check_write_block(req)

        if plan.preempt:
            return plan                    # let freed blocks settle one step

        # 2. resume swapped requests into free slots (FIFO).  Blocks the
        # preemption kept claims on (sharing-aware swap) re-attach in place;
        # only the exclusive suffix needs fresh blocks + the swap-in copy.
        resume_starved = False
        while self.swapped and self.free_slots:
            req = self.swapped[0]
            got = self.pool.alloc(self.pool.blocks_for(req.cached_len + 1)
                                  - len(req.kept_blocks))
            if got is None:
                if not self.running:
                    # nothing running can ever free more capacity, so a
                    # starved resume would deadlock: retained claims (ours
                    # and other swapped requests') have fragmented the pool.
                    # Downgrade the head to recompute-readmission — releasing
                    # its kept claims and swap blocks is sound because a
                    # re-prefill rebuilds everything from tokens.
                    self.swapped.popleft()
                    self._downgrade_to_recompute(req)
                    continue
                resume_starved = True       # kept claims stay held: content
                break                       # must survive until the resume
            self.swapped.popleft()
            kept = len(req.kept_blocks)
            table, req.kept_blocks = req.kept_blocks + got, []
            req.swap_block_ids = []         # engine/driver frees the ticket
            self._place(req, table, now)
            plan.resume.append(req)
            if self.tracer.enabled:
                self.tracer.instant(
                    "resume", "scheduler", "scheduler", ts=now,
                    args={"rid": req.rid, "slot": req.slot,
                          "reattached_blocks": kept,
                          "restored_blocks": len(got)},
                    flow=req.rid)

        # 3. admit arrived requests into the remaining free slots.  Not while
        # a swapped request is starved for blocks: a new admission would eat
        # the very blocks it is waiting for (resume priority must hold for
        # blocks, not just slots).  Admission allocates only the *marginal*
        # blocks beyond the resident shared prefix, and registers the new
        # prompt chain so later arrivals can share it.
        if self.admission_hold is not None:
            # degradation ladder top: admissions denied with a structured
            # retry-after; queued requests keep waiting (their queue_timeout
            # bounds the wait) and resume priority still drains the swapped
            if (self.tracer.enabled and self.waiting
                    and self.waiting[0][0] <= now):
                self.tracer.instant(
                    "admit-hold", "scheduler", "scheduler", ts=now,
                    args={"queued": len(self.waiting),
                          "retry_after_s": self.admission_hold})
            return plan
        while self.waiting and self.free_slots and not resume_starved:
            arrival, _, req = self.waiting[0]
            if arrival > now:
                break
            table, grant = self._admission_blocks(req)
            if table is None:
                if self.tracer.enabled:
                    self.tracer.instant(
                        "admit-deny", "scheduler", "scheduler", ts=now,
                        args={"rid": req.rid,
                              "need_blocks": self.pool.blocks_for(req.cached_len + 1),
                              "available_blocks": self.pool.available_blocks},
                        flow=req.rid)
                break
            heapq.heappop(self.waiting)
            self._place(req, table, now)
            if grant is not None:
                plan.grants[req.rid] = grant
            if (self.prefix_cache is not None and not req.extras
                    and self.prefix_retain and not self.defer_prefix_register):
                self.prefix_cache.register(req)
            self._check_write_block(req)
            plan.admit.append(req)
            if self.tracer.enabled:
                shared = grant.shared_blocks if grant is not None else 0
                args = {"rid": req.rid, "slot": req.slot,
                        "blocks": len(table),
                        "marginal_blocks": len(table) - shared
                        - (1 if grant is not None and grant.fork else 0),
                        "shared_blocks": shared,
                        "prefix_hit_tokens": grant.start if grant else 0}
                if req.tenant is not None:
                    args["tenant"] = req.tenant
                self.tracer.instant("admit", "scheduler", "scheduler",
                                    ts=now, args=args, flow=req.rid)

        return plan

    # -- mixed prefill+decode packing ---------------------------------------

    def pack_mixed(self, budget: int, chunk: int
                   ) -> Tuple[List[Request], List[Tuple[Request, int, int]]]:
        """Pack one fused dispatch under a total query-row ``budget``.

        Returns ``(decode, parts)``: running slots that ride at q_len = 1
        (their pending token decodes), and prefill assignments
        ``(request, start, rows)`` — ``rows`` replay tokens starting at
        replay offset ``start`` for each mid-prefill slot, capped at
        ``chunk`` rows per slot per dispatch.

        Fairness: decode rows are packed FIRST (Sarathi-style decode-
        priority — steady-state TPOT never waits on a prompt), so with
        ``budget ≥ running slots + 1`` no decode slot is ever skipped.
        Under pathological scarcity (budget < decode population + 1) a
        persistent round-robin cursor rotates which decode slots ride, so
        no slot waits more than one rotation.  When any slot is
        mid-prefill, one row is reserved for the oldest prefilling slot so
        prefill always progresses ≥ 1 row per dispatch (TTFT cannot starve
        behind decode either).

        Pure bookkeeping — no allocation happens here: admission already
        allocated the full replay footprint (``cached_len + 1`` rows), so
        every prefill write row is table-covered.
        """
        running = sorted(self.running.values(),
                         key=lambda r: (r.arrival, r.rid))
        prefilling = [r for r in running if r.prefilling]
        decoding = [r for r in running if not r.prefilling and not r.done]
        rows_left = max(1, budget)
        reserve = 1 if prefilling else 0
        decode: List[Request] = []
        if decoding:
            cap = max(0, rows_left - reserve)
            if len(decoding) <= cap:
                decode = list(decoding)
            elif cap:
                order = sorted(decoding, key=lambda r: r.slot)
                i0 = self._mixed_rr % len(order)
                decode = [order[(i0 + i) % len(order)] for i in range(cap)]
                self._mixed_rr = (i0 + cap) % len(order)
            rows_left -= len(decode)
        parts: List[Tuple[Request, int, int]] = []
        for r in prefilling:
            if rows_left <= 0:
                break
            c = min(chunk, r.cached_len - r.prefill_pos, rows_left)
            if c <= 0:
                continue
            parts.append((r, r.prefill_pos, c))
            rows_left -= c
        return decode, parts

    def finish_prefill(self, req: Request) -> None:
        """A staged (mixed-dispatch) prefill wrote its last replay row.

        Deferred prompt-chain registration happens here — the rows are now
        physically resident, so later arrivals may alias them safely."""
        req.prefilling = False
        req.prefill_pos = req.cached_len
        if (self.prefix_cache is not None and not req.extras
                and self.prefix_retain):
            self.prefix_cache.register(req)

    # -- horizon granting ---------------------------------------------------

    def grant_horizon(self, max_h: int, now: float,
                      est_step_time: float = 0.0, spec_k: int = 0) -> int:
        """Largest safe number of lockstep decode steps for one dispatch.

        Called after :meth:`plan` (so single-step growth is already settled)
        and before the engine launches its fused multi-step decode.  The
        grant is the min of three caps, snapped DOWN to a power of two so the
        engine compiles at most ``log2(max_h)+1`` horizon executables:

        1. **Completion events.**  While admissions or resumes are blocked on
           capacity (a swapped request, or an arrived request still queued),
           the horizon ends at the earliest running completion — min over
           running slots of remaining budget — so freed slots/blocks turn
           into admitted work at the boundary instead of idling frozen.
           (An early EOS can still freeze a slot mid-horizon; that waste is
           bounded by this same cap.)  With speculation an inner step emits
           up to ``spec_k + 1`` tokens, so the earliest completion is
           ``ceil(remaining / (spec_k+1))`` steps out.
        2. **Arrival events.**  With a free slot and a future arrival, the
           horizon stops roughly at the admission time (``est_step_time`` is
           the engine's measured per-token decode time; 0 disables the cap).
        3. **Block headroom.**  Every granted step must be able to write its
           KV rows: each running request's table is pre-extended *before*
           the dispatch so the paged kernel never indexes an unallocated
           page mid-horizon.  Speculative dispatches budget the worst case —
           every inner step writes ``spec_k + 1`` rows even when rejection
           rolls most of them back, and a slot that freezes on budget still
           wrote ``spec_k`` rows past its last accepted token — capped at
           ``max_len`` (the attention write path parks rows beyond the table
           span on the pool's write-off block).  If the pool cannot cover
           ``h`` steps the grant halves (never preempts); with speculation,
           an uncoverable ``h == 1`` returns 0 and the engine falls back to
           one plain decode step (plan()'s growth already covered one row).
        """
        running = sorted(self.running.values(), key=lambda r: (r.arrival, r.rid))
        if not running:
            return 0
        per = spec_k + 1
        h = max(1, max_h)
        if self.swapped or (self.waiting and self.waiting[0][0] <= now):
            h = min(h, max(1, min(-(-r.remaining // per) for r in running)))
        elif self.waiting and self.free_slots and est_step_time > 0:
            until = self.waiting[0][0] - now
            h = min(h, max(1, int(until / est_step_time) + 1))
        # deadline events: a past-deadline running request must be aborted at
        # the next step boundary, so cap the horizon roughly at the earliest
        # running deadline — a mid-horizon abort otherwise burns up to a full
        # grant of dead work before the engine's expiry sweep sees it
        deadlines = [r.deadline - now for r in running if r.deadline is not None]
        if deadlines and est_step_time > 0:
            h = min(h, max(1, int(min(deadlines) / (est_step_time * per)) + 1))
        h = 1 << (max(1, h).bit_length() - 1)          # snap down to 2^k

        def rows_for(r: Request, hh: int) -> int:
            return min(self.max_len,
                       r.cached_len + min(hh * per, r.remaining + spec_k))

        def extra_blocks(hh: int) -> int:
            return sum(
                max(0, self.pool.blocks_for(rows_for(r, hh))
                    - len(r.block_table))
                for r in running)

        while h > 1 and extra_blocks(h) > self.pool.available_blocks:
            h //= 2
        if spec_k and (extra_blocks(h) > self.pool.available_blocks or any(
                self.pool.blocks_for(rows_for(r, h)) > self.pool.usable_blocks
                for r in running)):
            h = 0                           # this step cannot verify a draft
        grew = False
        while h and (h > 1 or spec_k):
            ok = True
            for r in running:
                before = len(r.block_table)
                ok = self.pool.extend_to(r.block_table, rows_for(r, h))
                grew |= len(r.block_table) != before
                if not ok:
                    break
            if ok:
                break
            # headroom vanished between the check and the extension (an
            # injected allocation fault, or a reclaimer that reported blocks
            # it could not deliver): halve the grant and retry with whatever
            # partial extension already landed — never crash, never preempt.
            # With speculation an uncoverable h == 1 degrades to 0 and the
            # engine falls back to one plain decode step (plan()'s growth
            # already covered that row).
            h = h // 2 if h > 1 else 0
        if grew:
            self.table_version += 1
        if self.tracer.enabled:
            self.tracer.instant(
                "grant_horizon", "scheduler", "scheduler", ts=now,
                args={"max_h": max_h, "granted": h, "spec_k": spec_k,
                      "running": len(running), "swapped": len(self.swapped),
                      "queued": len(self.waiting),
                      "free_slots": len(self.free_slots),
                      "available_blocks": self.pool.available_blocks,
                      "est_step_time_s": est_step_time})
        return h
