"""Paged KV-cache residency as a simulated resource.

The serving stack's decode steps used to price attention as if every
request's KV cache were free and always resident — the realism gap
ROADMAP flags for decode-heavy traffic.  This module makes residency a
first-class, *simulated* resource, in the same spirit as the DES's
``BandwidthResource`` loaders: the KV working set lives in fixed-size
**blocks** (the vLLM block-table idiom) over two tiers,

* **hot** — scratchpad-bank slots, a fixed pool of ``hot_blocks``
  physical slots the allocator hands out;
* **cold** — DRAM (an ``lru`` demotion keeps the bytes) or dropped
  (the ``recompute`` policy throws them away and re-derives on touch).

Touching a cold block owes a **refill**: ``block_bytes`` of loader
traffic for an LRU demotion, ``RECOMPUTE_REFILL_FACTOR × block_bytes``
for a dropped block (activations stream back in and the block's K/V is
re-emitted — a first-order recompute price).  The serving scheduler
threads per-request residency through ``PolicyContext`` so
``decode-priority`` can prefer hot-KV requests, stamps each step's owed
refill bytes onto the ``BatchSchedule``, and ``sim.lower`` turns them
into real ``memory`` TaskGraph nodes riding the shared loader — so the
DES and the analytical cluster form both price a visible refill cost,
while execution (which skips memory nodes) stays bit-exact.

Everything here is deterministic given ``(seed, call order)``: the free
list is a seeded shuffle, recency is a ``(time, seq)`` pair with a
monotonic logical sequence as the tiebreak, and every mutation appends
to :attr:`PagedKVCache.trace` — byte-identical across runs.
"""

from __future__ import annotations

import dataclasses
import hashlib
import random
from typing import List, Optional, Tuple

#: refill multiplier for the ``recompute`` policy: a dropped block's K/V
#: must be re-derived, so the loader moves the block's activations back
#: in *and* the recomputed K/V out — priced first-order as 2x the plain
#: DRAM reload an ``lru`` demotion costs.
RECOMPUTE_REFILL_FACTOR = 2.0

#: supported eviction policies.
EVICTION_POLICIES = ("lru", "recompute")


class KVPoolExhausted(RuntimeError):
    """No evictable block: every hot slot is pinned by the operation in
    progress (one request's working set exceeds the whole hot pool)."""


def kv_bytes_per_token(cfg, dtype_bytes: float = 1.0) -> float:
    """Bytes of K+V one token occupies across all layers of ``cfg``
    (int8 cache by default): ``2 * kv_dim * n_layers * dtype_bytes``."""
    return 2.0 * cfg.kv_dim * cfg.n_layers * float(dtype_bytes)


def refill_cycles(refill_bytes: float, unit, platform,
                  units: int = 1) -> float:
    """Loader cycles a KV refill of ``refill_bytes`` occupies — the same
    price the DES charges a ``memory`` node: the shared pool's bytes per
    cycle (``units × unit.bandwidth / freq``) derated by the platform's
    DRAM efficiency.  Matches ``ClusterMachine.memory_node_bpc`` on the
    default homogeneous pool and the single-unit ``Machine`` at
    ``units=1``."""
    if refill_bytes <= 0.0:
        return 0.0
    bpc = (unit.bandwidth * max(1, units) / unit.freq_hz
           * platform.dram_efficiency)
    return float(refill_bytes) / bpc


@dataclasses.dataclass
class Block:
    """One logical KV block of a request's sequence."""

    rid: int                    # owning request
    tokens: int                 # tokens written (<= block_tokens)
    hot: bool = True            # True: scratchpad slot; False: cold
    dropped: bool = False       # recompute policy threw the bytes away
    slot: Optional[int] = None  # physical hot slot id (None when cold)
    last_used: Tuple[float, int] = (0.0, 0)


class PagedKVCache:
    """Fixed-size paged KV block allocator over hot/cold tiers.

    ``hot_blocks`` physical scratchpad slots are shared by every
    request; ``block_tokens`` tokens fit one block and one block holds
    ``block_tokens × kv_bytes_per_token`` bytes.  ``policy`` picks what
    eviction does with the bytes (``lru`` demotes to DRAM, ``recompute``
    drops), ``seed`` fixes the free-list order.  All mutating calls
    take the simulation time ``t`` (cycles) for LRU recency and event
    stamping; ties break on a monotonic internal sequence, so behaviour
    is a pure function of ``(seed, call order)``.
    """

    def __init__(self, *, hot_blocks: int, block_tokens: int = 16,
                 kv_bytes_per_token: float = 1.0, policy: str = "lru",
                 seed: int = 0):
        if policy not in EVICTION_POLICIES:
            raise ValueError(f"unknown eviction policy {policy!r}; "
                             f"choose from {EVICTION_POLICIES}")
        if hot_blocks < 1:
            raise ValueError(f"hot_blocks must be >= 1, got {hot_blocks}")
        if block_tokens < 1:
            raise ValueError(f"block_tokens must be >= 1, "
                             f"got {block_tokens}")
        self.hot_blocks = int(hot_blocks)
        self.block_tokens = int(block_tokens)
        self.kv_bytes_per_token = float(kv_bytes_per_token)
        self.block_bytes = self.block_tokens * self.kv_bytes_per_token
        self.policy = policy
        self.seed = int(seed)
        slots = list(range(self.hot_blocks))
        random.Random(self.seed).shuffle(slots)
        self._free: List[int] = slots        # pop from the end
        self._seqs: "dict[int, list[Block]]" = {}
        self._seq = 0
        #: append-only event log — ``(kind, time, rid, slot, extra)``
        #: tuples, byte-identical across runs given (seed, call order).
        self.trace: "list[tuple]" = []
        self.counters = {"allocs": 0, "evictions": 0, "refills": 0,
                         "refill_bytes": 0.0, "frees": 0}

    # ----- introspection ---------------------------------------------------
    def free_slots(self) -> Tuple[int, ...]:
        """Currently free hot slot ids, sorted."""
        return tuple(sorted(self._free))

    def allocated_slots(self) -> Tuple[int, ...]:
        """Hot slot ids currently owned by some block, sorted."""
        return tuple(sorted(b.slot for bs in self._seqs.values()
                            for b in bs if b.hot))

    def blocks_of(self, rid: int) -> Tuple[Block, ...]:
        return tuple(self._seqs.get(rid, ()))

    def tokens_of(self, rid: int) -> int:
        return sum(b.tokens for b in self._seqs.get(rid, ()))

    def residency(self, rid: int) -> float:
        """Hot fraction of ``rid``'s blocks — 1.0 for an empty (or
        unknown) request: nothing cached means nothing to refill."""
        blocks = self._seqs.get(rid, ())
        if not blocks:
            return 1.0
        return sum(1 for b in blocks if b.hot) / len(blocks)

    def refill_bytes(self, rid: int) -> float:
        """Loader bytes owed before ``rid`` can decode: cold blocks at
        ``block_bytes``, dropped blocks at the recompute factor."""
        total = 0.0
        for b in self._seqs.get(rid, ()):
            if not b.hot:
                total += self.block_bytes * (RECOMPUTE_REFILL_FACTOR
                                             if b.dropped else 1.0)
        return total

    def trace_digest(self) -> str:
        """SHA-256 over the repr of the event log — the determinism
        contract: same seed + same call order -> same digest."""
        return hashlib.sha256(repr(self.trace).encode()).hexdigest()

    # ----- mutation --------------------------------------------------------
    def _key(self, t: float) -> Tuple[float, int]:
        self._seq += 1
        return (float(t), self._seq)

    def _evict_one(self, t: float, pinned: "set[int]"):
        """Evict the least-recently-used unpinned hot block; returns
        ``(freed slot, (victim rid, slot, tier))``."""
        victims = [b for bs in self._seqs.values() for b in bs
                   if b.hot and b.slot not in pinned]
        if not victims:
            raise KVPoolExhausted(
                f"all {self.hot_blocks} hot blocks are pinned by the "
                f"operation in progress; the hot pool is smaller than "
                f"one request's working set")
        victim = min(victims, key=lambda b: b.last_used)
        slot, tier = victim.slot, \
            ("dropped" if self.policy == "recompute" else "dram")
        victim.hot = False
        victim.dropped = self.policy == "recompute"
        victim.slot = None
        self.counters["evictions"] += 1
        self.trace.append(("evict", float(t), victim.rid, slot, tier))
        return slot, (victim.rid, slot, tier)

    def _alloc_slot(self, rid: int, t: float, pinned: "set[int]"):
        if self._free:
            return self._free.pop(), None
        return self._evict_one(t, pinned)

    def append(self, rid: int, n_tokens: int, t: float = 0.0):
        """Write ``n_tokens`` of fresh KV for ``rid`` (a prefill chunk
        or decode iterations), allocating hot blocks as needed.  Returns
        the list of ``(victim rid, slot, tier)`` evictions this caused.
        Blocks allocated by this call are pinned against self-eviction.
        """
        if n_tokens <= 0:
            return []
        blocks = self._seqs.setdefault(rid, [])
        key = self._key(t)
        evicted = []
        pinned: "set[int]" = {b.slot for b in blocks if b.hot}
        left = int(n_tokens)
        if blocks and blocks[-1].hot \
                and blocks[-1].tokens < self.block_tokens:
            take = min(left, self.block_tokens - blocks[-1].tokens)
            blocks[-1].tokens += take
            left -= take
        while left > 0:
            slot, ev = self._alloc_slot(rid, t, pinned)
            if ev is not None:
                evicted.append(ev)
            take = min(left, self.block_tokens)
            blocks.append(Block(rid=rid, tokens=take, hot=True,
                                slot=slot, last_used=key))
            pinned.add(slot)
            left -= take
            self.counters["allocs"] += 1
            self.trace.append(("alloc", float(t), rid, slot, take))
        for b in blocks:            # the whole sequence was just touched
            if b.hot:
                b.last_used = key
        return evicted

    def ensure_resident(self, rid: int, t: float = 0.0):
        """Bring every cold block of ``rid`` back hot, evicting LRU
        victims from *other* requests as needed.  Returns ``(refill
        bytes charged, evictions caused)`` — the bytes are what the
        scheduler lowers into a ``memory`` node."""
        blocks = self._seqs.get(rid, ())
        key = self._key(t)
        total, evicted = 0.0, []
        pinned: "set[int]" = {b.slot for b in blocks if b.hot}
        for b in blocks:
            if b.hot:
                b.last_used = key
                continue
            slot, ev = self._alloc_slot(rid, t, pinned)
            if ev is not None:
                evicted.append(ev)
            cost = self.block_bytes * (RECOMPUTE_REFILL_FACTOR
                                       if b.dropped else 1.0)
            b.hot, b.dropped, b.slot, b.last_used = True, False, slot, key
            pinned.add(slot)
            total += cost
            self.counters["refills"] += 1
            self.counters["refill_bytes"] += cost
            self.trace.append(("refill", float(t), rid, slot, cost))
        return total, evicted

    def release(self, rid: int, t: float = 0.0) -> int:
        """Free every block of a finished request; returns how many hot
        slots went back to the pool."""
        blocks = self._seqs.pop(rid, ())
        freed = 0
        for b in blocks:
            if b.hot:
                self._free.append(b.slot)
                freed += 1
                self.counters["frees"] += 1
                self.trace.append(("free", float(t), rid, b.slot, b.tokens))
        return freed
