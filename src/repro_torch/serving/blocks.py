"""Paged KV-cache block pool: fixed-size blocks, block tables, swap store.

Two tiers, mirroring the classic paged-KV serving design:

* :class:`BlockPool` — a pure-accounting, **refcounted** free-list allocator
  over fixed-size token blocks (copied unchanged from the JAX package: it
  holds no arrays).  One pool instance budgets the *device* KV memory — the
  ``k_pool/v_pool`` leaves the paged-attention kernel indexes; a second
  instance inside :class:`PagedKVStore` budgets the swap tier.

* :class:`PagedKVStore` — block-granular storage for *preempted* sequences
  on the engine's device.  Pool leaves (``k_pool/v_pool``) swap by block-table
  handoff: ``swap_out`` copies the request's device blocks (by id) into swap
  blocks with one torch index copy per leaf, ``swap_in`` copies them back into
  whatever device blocks the scheduler hands the resumed request.  Dense
  sequence leaves (``k/v [L, slots, rows, ...]``: the dense live cache and
  the sliding-window rings) copy the slot's rows block by block into the
  same swap blocks.  The other per-slot leaves (``pos`` and recurrent state
  such as the SSM's ``h`` and ``conv``) ride along in the
  :class:`SwapTicket`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.nn.attention import POOL_LEAVES
from repro_torch.serving.faults import SwapCopyError
from repro_torch.serving.trace import NULL_TRACER
from repro_torch.tree import leaves_with_path

__all__ = ["BlockPool", "PagedKVStore", "SwapTicket"]

# Dense cache leaves with a sequence axis (slot axis 1, rows axis 2).
SEQ_LEAVES = ("k", "v", "c_kv", "k_rope")


class BlockPool:
    """Refcounted free-list allocator over ``n_blocks`` fixed-size token blocks.

    All-or-nothing ``alloc`` (returns None when the request cannot be met in
    full), double-free checked ``free``.  Pure bookkeeping — no arrays.

    Blocks carry a **refcount** so block tables may alias the same physical
    block (prefix sharing): ``alloc`` hands out blocks at refcount 1,
    ``share`` adds a claim, ``free`` drops one — the block returns to the
    free list only when its last claim is gone.  ``fork`` is the
    copy-on-write primitive: trading a claim on a shared block for a fresh
    exclusive block (the caller copies the contents before writing).

    A ``reclaimer`` (duck-typed: ``reclaimable() -> int`` and
    ``reclaim(n) -> int``) may be attached by a block cache that retains
    otherwise-unreferenced blocks (the scheduler's prefix cache); ``alloc``
    asks it to release blocks before failing, so cached prefixes are evicted
    lazily under allocation pressure instead of eagerly on request
    completion.

    **PCRAM reliability**: the pool is the physical PCRAM, so it
    carries per-block *write-endurance* accounting — ``record_writes`` bumps
    a per-block wear counter (rows written) and a last-write wall clock, a
    host-side mirror of device writes derived from the scheduler/StepPlan
    bookkeeping.  ``policy="min_wear"`` orders the free list by a
    wear-then-age score so allocation always picks the least-worn block
    (ties: oldest-freed first), narrowing the wear distribution vs. the seed
    LIFO order.  Blocks may be *retired* (bad-block management):
    ``retire_free`` pulls a free block out of circulation, ``retire_used``
    swaps a referenced block for a fresh one (the caller copies contents and
    remaps tables).  Retired blocks shrink :attr:`usable_blocks`; the
    conservation law becomes free ∪ referenced ∪ retired == pool.
    """

    def __init__(self, n_blocks: int, block_size: int, *,
                 policy: str = "lifo", endurance_budget: Optional[int] = None):
        if n_blocks < 0 or block_size <= 0:
            raise ValueError((n_blocks, block_size))
        if policy not in ("lifo", "min_wear"):
            raise ValueError(f"unknown alloc policy {policy!r}")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.policy = policy
        self.endurance_budget = endurance_budget
        self._free: List[int] = list(range(n_blocks - 1, -1, -1))
        self._refs: Dict[int, int] = {}
        self.reclaimer = None
        # per-block endurance accounting (host mirror of device writes)
        self.wear = np.zeros(n_blocks, np.int64)        # cache rows written
        self.last_write = np.full(n_blocks, -1.0)       # wall clock, -1 ⇒ never
        self.total_writes = 0                           # monotone row counter
        self.retired: set = set()                       # bad blocks, out of play
        self._freed_seq = np.zeros(n_blocks, np.int64)  # age tiebreak for min_wear
        self._seq = 0
        self._free_dirty = False
        # armed fault injection: the next N non-empty allocs fail (None
        # return, pool untouched) regardless of headroom — exercises every
        # caller's exhaustion fallback at moments the headroom math says are
        # impossible
        self._forced_failures = 0
        # structured-event recorder (repro.serving.trace); the engine swaps
        # in its Tracer — the no-op default keeps every emit site free
        self.tracer = NULL_TRACER

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return len(self._refs)

    @property
    def available_blocks(self) -> int:
        """Blocks an ``alloc`` could obtain right now: free + reclaimable."""
        extra = self.reclaimer.reclaimable() if self.reclaimer is not None else 0
        return len(self._free) + extra

    @property
    def usable_blocks(self) -> int:
        """Total capacity net of retired bad blocks — what admission and
        horizon grants must size against once retirement shrinks the pool."""
        return self.n_blocks - len(self.retired)

    def refs(self, bid: int) -> int:
        """Current claim count on block ``bid`` (0 ⇒ free or out of range)."""
        return self._refs.get(bid, 0)

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` cache rows."""
        return -(-max(n_tokens, 0) // self.block_size)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` block ids at refcount 1, or None (no change) if
        unavailable even after asking the reclaimer to evict.  Eviction is
        only asked for when it can actually cover the shortfall — a doomed
        allocation must not wipe the resident prefix cache for nothing."""
        if n < 0:
            raise ValueError(n)
        if n > 0 and self._forced_failures:
            self._forced_failures -= 1
            if self.tracer.enabled:
                self.tracer.instant("alloc-fault", "pool", "pool",
                                    args={"n": n, "free": len(self._free)})
            return None
        if n > len(self._free) and self.reclaimer is not None \
                and n <= len(self._free) + self.reclaimer.reclaimable():
            self.reclaimer.reclaim(n - len(self._free))
        if n > len(self._free):
            return None
        if self.policy == "min_wear" and self._free_dirty:
            # lazy re-sort: pop() must yield the least-worn free block, ties
            # broken oldest-freed-first (the age half of the hybrid score)
            self._free.sort(key=lambda b: (self.wear[b], self._freed_seq[b]),
                            reverse=True)
            self._free_dirty = False
        ids = [self._free.pop() for _ in range(n)]
        for b in ids:
            self._refs[b] = 1
        if n and self.tracer.enabled:
            self.tracer.instant("alloc", "pool", "pool",
                                args={"n": n, "free_after": len(self._free)})
        return ids

    def share(self, ids: List[int]) -> None:
        """Add one claim to each allocated block (prefix-sharing attach)."""
        for b in ids:
            if b not in self._refs:
                raise ValueError(f"share of unallocated block {b}")
        for b in ids:
            self._refs[b] += 1

    def free(self, ids: List[int]) -> None:
        """Drop one claim per id; blocks are released at refcount 0."""
        released = 0
        for b in ids:
            if b not in self._refs:
                raise ValueError(f"double free of block {b}")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                del self._refs[b]
                self._free.append(b)
                self._seq += 1
                self._freed_seq[b] = self._seq
                self._free_dirty = True
                released += 1
        if ids and self.tracer.enabled:
            self.tracer.instant("release", "pool", "pool",
                                args={"n": len(ids), "released": released,
                                      "free_after": len(self._free)})

    def fork(self, bid: int) -> Optional[int]:
        """Copy-on-write fork of one claim on ``bid``.

        Exclusive block (refcount 1): returned as-is — the caller may write
        in place.  Shared block: allocates a fresh block, releases the
        caller's claim on ``bid``, and returns the new id; the caller must
        copy the block contents before writing.  None ⇒ pool exhausted (the
        claim on ``bid`` is kept so the caller can roll back).
        """
        if bid not in self._refs:
            raise ValueError(f"fork of unallocated block {bid}")
        if self._refs[bid] == 1:
            return bid
        got = self.alloc(1)
        if got is None:
            return None
        self.free([bid])
        if self.tracer.enabled:
            self.tracer.instant("fork", "pool", "pool",
                                args={"src": bid, "dst": got[0]})
        return got[0]

    def extend_to(self, table: List[int], n_tokens: int) -> bool:
        """Grow a block table in place until it covers ``n_tokens`` cache rows.

        All-or-nothing like :meth:`alloc`: returns False (table unchanged)
        when the pool cannot supply every missing block.  Shared by the
        scheduler's per-step growth and the horizon pre-reservation.  A
        target beyond the pool's total capacity can never be satisfied — it
        raises instead of letting the caller retry (and preempt victims)
        forever on a grant the pool cannot honor.
        """
        need = self.blocks_for(n_tokens)
        if need > self.n_blocks:
            raise ValueError(
                f"block-table grant for {n_tokens} tokens needs {need} blocks "
                f"but the pool only has {self.n_blocks} — the grant exceeds "
                f"pool capacity and can never be satisfied")
        if need <= len(table):
            return True
        got = self.alloc(need - len(table))
        if got is None:
            return False
        table.extend(got)
        return True

    def record_writes(self, pairs: Iterable[Tuple[int, int]],
                      now: float = 0.0) -> int:
        """Bill device writes to the endurance accounting.

        ``pairs`` is ``(block_id, rows_written)`` — the host-side mirror of a
        dispatch's KV scatters / block copies.  Bumps per-block wear and the
        last-write clock; returns total rows billed.  Writes to retired
        blocks are a bookkeeping bug upstream — rejected loudly.
        """
        rows = 0
        for bid, n in pairs:
            if n <= 0:
                continue
            if bid in self.retired:
                raise ValueError(f"write billed to retired block {bid}")
            self.wear[bid] += n
            self.last_write[bid] = now
            rows += n
        self.total_writes += rows
        return rows

    def over_budget(self) -> List[int]:
        """Non-retired blocks whose wear has crossed the endurance budget."""
        if self.endurance_budget is None:
            return []
        worn = np.flatnonzero(self.wear >= self.endurance_budget)
        return [int(b) for b in worn if b not in self.retired]

    def retire_free(self, bid: int) -> None:
        """Retire a block that currently sits on the free list."""
        if bid in self.retired:
            return
        if bid in self._refs:
            raise ValueError(f"retire_free of referenced block {bid}")
        self._free.remove(bid)
        self.retired.add(bid)
        if self.tracer.enabled:
            self.tracer.instant("retire", "pool", "pool",
                                args={"block": bid, "wear": int(self.wear[bid]),
                                      "usable": self.usable_blocks})

    def retire_used(self, bid: int) -> Optional[int]:
        """Retire a *referenced* block: allocate a replacement, transfer the
        refcount claims to it, and retire ``bid``.  Returns the replacement
        id (the caller must copy contents and remap every table that held
        ``bid``), or None when no replacement block is available — ``bid``
        stays live and the caller retries later."""
        if bid in self.retired:
            return None
        if bid not in self._refs:
            raise ValueError(f"retire_used of unreferenced block {bid}")
        got = self.alloc(1)
        if got is None:
            return None
        new = got[0]
        self._refs[new] = self._refs.pop(bid)
        self.retired.add(bid)
        if self.tracer.enabled:
            self.tracer.instant("retire", "pool", "pool",
                                args={"block": bid, "remap_to": new,
                                      "wear": int(self.wear[bid]),
                                      "usable": self.usable_blocks})
        return new

    def arm_alloc_failures(self, n: int = 1) -> None:
        """Fault injection: make the next ``n`` non-empty allocations fail
        (return None, pool untouched) even with headroom available."""
        if n < 0:
            raise ValueError(n)
        self._forced_failures += n

    def snapshot(self) -> Tuple[List[int], Dict[int, int]]:
        """(free ids, refcounts) copies — for invariant-checking tests."""
        return list(self._free), dict(self._refs)



@dataclass
class SwapTicket:
    """Handle for one swapped-out sequence: swap-tier block ids plus the
    non-paged slot state (recurrent states, per-slot position vectors).

    ``skip_blocks`` leading device blocks were *retained* instead of copied
    (sharing-aware swap: the scheduler kept refcount claims on blocks other
    tables or the prefix cache still hold on-device) — the ticket covers only
    the exclusive suffix, and swap-in restores into table rows
    ``skip_blocks`` onward."""

    block_ids: List[int]
    n_tokens: int
    side: Dict[str, torch.Tensor] = field(default_factory=dict)
    skip_blocks: int = 0


class PagedKVStore:
    """Swap-tier paged storage matching one serving-cache layout.

    Built from a serving cache tree (``init_serving_caches``); allocates a
    ``[n_blocks, L, block_size, *trailing]`` buffer per pool leaf and per
    dense sequence leaf, on the leaf's device.  A sliding-window ring is
    clamped to its capacity: a ring of ``rows`` rows only ever occupies the
    first ``rows / block_size`` blocks of the table, and restoring its rows
    and ``pos`` restores the ring exactly.  Copies update the engine's cache
    tensors in place.
    """

    def __init__(self, caches, n_blocks: int, block_size: int):
        self.block_size = block_size
        self.pool = BlockPool(n_blocks, block_size)
        # armed fault injection: the next N copies in the given direction
        # raise SwapCopyError *before* touching any state
        self._fail_out = 0
        self._fail_in = 0
        self.bufs: Dict[str, torch.Tensor] = {}
        self.pool_keys: set = set()
        for key, name, leaf in leaves_with_path(caches):
            if name in POOL_LEAVES:
                L, _, bs, *trail = leaf.shape
                if bs != block_size:
                    raise ValueError(
                        f"pool leaf {key} block size {bs} != "
                        f"store block size {block_size}")
                self.pool_keys.add(key)
            elif name in SEQ_LEAVES:
                L, _, size, *trail = leaf.shape
                if size % block_size:
                    raise ValueError(
                        f"cache seq axis {size} of {key} not divisible "
                        f"by block_size {block_size}")
            else:
                continue
            self.bufs[key] = torch.zeros(
                (n_blocks, L, block_size, *trail), dtype=leaf.dtype,
                device=leaf.device)

    def arm_swap_failures(self, direction: str, n: int = 1) -> None:
        """Fault injection: the next ``n`` copies in ``direction`` ("out" or
        "in") raise :class:`SwapCopyError` before touching any state."""
        if direction == "out":
            self._fail_out += n
        elif direction == "in":
            self._fail_in += n
        else:
            raise ValueError(f"direction must be 'out' or 'in', got {direction!r}")

    def _nb_leaf(self, leaf, nb: int) -> int:
        # ring-buffer leaves are smaller than the table they are filed under
        return min(nb, leaf.shape[2] // self.block_size)

    def swap_out(self, caches, slot: int, block_ids: List[int], n_tokens: int,
                 dev_ids: Optional[List[int]] = None,
                 skip: int = 0) -> SwapTicket:
        """Copy ``slot``'s cache state into swap blocks; returns the ticket.

        ``dev_ids`` is the request's device block table at preemption time —
        pool leaves copy those blocks directly (block-table handoff); dense
        sequence leaves copy the slot's rows.  ``skip`` leading device blocks
        are retained on-device by the scheduler (sharing-aware swap) and
        excluded from the copy.
        """
        if self._fail_out:
            self._fail_out -= 1
            raise SwapCopyError("injected swap-out copy fault")
        bs = self.block_size
        ticket = SwapTicket(list(block_ids), n_tokens, skip_blocks=skip)
        for key, _, leaf in leaves_with_path(caches):
            dev = leaf.device
            if key in self.pool_keys:
                if dev_ids is None:
                    raise ValueError(f"pool leaf {key} needs dev_ids to swap out")
                nbl = min(len(block_ids), len(dev_ids) - skip)
                ids = torch.as_tensor(block_ids[:nbl], dtype=torch.long, device=dev)
                src = torch.as_tensor(dev_ids[skip:skip + nbl], dtype=torch.long,
                                      device=dev)
                self.bufs[key][ids] = leaf[:, src].transpose(0, 1)
            elif key in self.bufs:
                nbl = max(0, self._nb_leaf(leaf, skip + len(block_ids)) - skip)
                ids = torch.as_tensor(block_ids[:nbl], dtype=torch.long, device=dev)
                seg = leaf[:, slot, skip * bs:(skip + nbl) * bs]
                self.bufs[key][ids] = seg.reshape(
                    leaf.shape[0], nbl, bs, *leaf.shape[3:]).transpose(0, 1)
            else:
                ticket.side[key] = leaf[:, slot].clone()
        return ticket

    def swap_in(self, caches, slot: int, ticket: SwapTicket,
                dev_ids: Optional[List[int]] = None):
        """Copy a ticket's state back into ``slot``; returns the caches
        (updated in place).

        ``dev_ids``: the freshly allocated device block table of the resumed
        request — pool leaves restore into those blocks.  A ticket with
        ``skip_blocks`` restores into table rows ``skip_blocks`` onward.
        """
        if self._fail_in:
            self._fail_in -= 1
            raise SwapCopyError("injected swap-in copy fault")
        bs = self.block_size
        skip = ticket.skip_blocks
        for key, _, leaf in leaves_with_path(caches):
            dev = leaf.device
            if key in self.pool_keys:
                if dev_ids is None:
                    raise ValueError(f"pool leaf {key} needs dev_ids to swap in")
                nbl = min(len(ticket.block_ids), len(dev_ids) - skip)
                ids = torch.as_tensor(ticket.block_ids[:nbl], dtype=torch.long,
                                      device=dev)
                dst = torch.as_tensor(dev_ids[skip:skip + nbl], dtype=torch.long,
                                      device=dev)
                leaf[:, dst] = self.bufs[key][ids].transpose(0, 1)
            elif key in self.bufs:
                nbl = max(0, self._nb_leaf(leaf, skip + len(ticket.block_ids)) - skip)
                ids = torch.as_tensor(ticket.block_ids[:nbl], dtype=torch.long,
                                      device=dev)
                seg = self.bufs[key][ids].transpose(0, 1)          # [L, nbl, bs, ..]
                leaf[:, slot, skip * bs:(skip + nbl) * bs] = seg.reshape(
                    leaf.shape[0], nbl * bs, *leaf.shape[3:])
            elif key in ticket.side:
                leaf[:, slot] = ticket.side[key]
            else:  # pragma: no cover — layout mismatch
                raise KeyError(f"leaf {key} missing from swap ticket")
        return caches
