"""Pluggable serving batching policies — the policy half of ``plan``.

``ServingEngine.plan`` used to hard-code one batching policy (full
prefill, then lockstep decode).  The paper attributes a large share of
CUTEv2's end-to-end gain to *overlapped* matrix–vector execution exposed
by the asynchronous abstraction; at serving scale that overlap is a
scheduling decision — when a request's prefill chunks run relative to
the decode iterations already in flight.  This module makes that
decision pluggable:

* :class:`SchedulingPolicy` — the protocol: ``schedule(PolicyContext)``
  lowers the pending queue into a
  :class:`~repro_torch.serving.engine.BatchSchedule`.
* a registry (``register_policy`` / ``get_policy``) with three built-in
  policies:

  ===================  ====================================================
  ``full-prefill``     today's behaviour, bit-identical schedules: per
                       padded batch, one whole-prompt prefill step then
                       all decode steps lockstep.  Best per-token cadence,
                       worst queueing — a later batch waits for every
                       earlier batch's complete drain.
  ``chunked-prefill``  Sarathi-style: the prompt is split into
                       ``chunk_tokens``-token chunks and in-flight decode
                       iterations *piggyback* on each chunk (one mixed
                       step), so prefill of batch *i+1* overlaps decode of
                       batch *i*.  Throughput-oriented; decode tokens
                       surface once per chunk.
  ``decode-priority``  decode steps preempt prefill chunks at layer
                       granularity: each scheduling round runs one merged
                       decode iteration of everything in flight *before*
                       the next prefill chunk, and the drain is a fair
                       round-robin across batches — decode first-token
                       latency is bounded by chunks-per-prefill rather
                       than whole earlier drains.  On a cluster it pins
                       decode steps to unit 0 via affinity hints (list
                       the fastest unit first in a heterogeneous
                       topology).
  ===================  ====================================================

Every policy lowers to the same ``BatchSchedule`` → ``workload_to_graph``
path, so any policy is priceable on ``desim`` / ``desim-cluster``
timelines, priced by the contention-aware ``analytical`` closed form
without running the DES, and executed bit-exactly through K1 (the
``desim`` / ``desim-cluster`` numeric half).  Two scheduling axes ride
along the schedule itself:
**arrival times** (``PolicyContext.arrival_times`` → per-step release
times → ``Node.release_time``, so TTFT reflects queueing under load
instead of the all-at-t=0 lower bound) and the **overlap mode**
(``chained`` serial vs ``relaxed`` true per-request hazards only — see
``BatchSchedule.step_deps``).
:func:`decode_latency_stats` turns per-step prices into the serving
metrics (TTFT p50/p99 from each request's own arrival, inter-token
latency, overlap-aware makespan) and :func:`select_schedule` auto-picks
the best (policy × partition × overlap) candidate —
``plan(policy="auto")``.
"""

from __future__ import annotations

import abc
import dataclasses
import math
from typing import Optional


# ---------------------------------------------------------------------------
# Context + registry.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PolicyContext:
    """Everything a batching policy may look at: the queue (per-request
    prompt lengths, in submission order), the engine's batching limit,
    the decode horizon, the cluster width the schedule targets, and the
    per-request arrival times.

    ``arrival_times`` (cycles, one per request, non-decreasing — the
    queue is the arrival order) is how load reaches the plan: a step's
    release time is the latest arrival among its requests, stamped onto
    the lowered graph as ``Node.release_time`` and used as the TTFT
    baseline by :func:`decode_latency_stats`.  Empty means the classic
    all-arrived-at-t=0 queue.

    ``prefill_progress`` / ``decode_done`` carry **partial state across
    re-plans** — the online loop's currency: per request, how many
    prompt tokens are already prefilled and how many decode iterations
    already emitted.  A request whose prefill completed in an earlier
    epoch re-enters the plan as *carryover* (:meth:`carryover`): it
    skips prefill and only its owed decode iterations are scheduled.
    Both default empty — all-zero progress, the classic one-shot plan,
    bit-identical to the pre-online behaviour.

    ``kv_residency`` / ``kv_refill_bytes`` thread the paged KV cache's
    state (:mod:`repro_torch.serving.kvcache`) into the plan: per request, the
    hot fraction of its KV blocks and the loader bytes owed before it
    can decode again.  A policy may *prefer* hot requests
    (``decode-priority`` does); either way :meth:`SchedulingPolicy
    ._finish` stamps each request's owed refill onto the first step that
    touches it, so the lowering prices the refill as a real ``memory``
    node.  Both default empty — KV is free and always resident, the
    classic behaviour.
    """

    cfg: object                       # models.base.ArchConfig
    prompt_lengths: "tuple[int, ...]"
    max_batch: int
    max_new_tokens: int
    units: int = 1
    arrival_times: "tuple[float, ...]" = ()
    prefill_progress: "tuple[int, ...]" = ()
    decode_done: "tuple[int, ...]" = ()
    kv_residency: "tuple[float, ...]" = ()
    kv_refill_bytes: "tuple[float, ...]" = ()

    def __post_init__(self):
        for field in ("arrival_times", "prefill_progress", "decode_done",
                      "kv_residency", "kv_refill_bytes"):
            val = getattr(self, field)
            if val and len(val) != len(self.prompt_lengths):
                raise ValueError(
                    f"{len(val)} {field} for "
                    f"{len(self.prompt_lengths)} requests")
        if any(not 0.0 <= r <= 1.0 for r in self.kv_residency):
            raise ValueError(f"kv_residency outside [0, 1]: "
                             f"{self.kv_residency}")
        if any(b < 0.0 for b in self.kv_refill_bytes):
            raise ValueError(f"negative kv_refill_bytes: "
                             f"{self.kv_refill_bytes}")

    def arrival_of(self, request: int) -> float:
        """Arrival cycle of a request (0.0 when arrivals untracked)."""
        return (self.arrival_times[request]
                if request < len(self.arrival_times) else 0.0)

    def residency_of(self, request: int) -> float:
        """Hot-KV fraction of a request (1.0 when residency untracked —
        the classic everything-is-resident assumption)."""
        return (self.kv_residency[request]
                if request < len(self.kv_residency) else 1.0)

    def refill_of(self, request: int) -> float:
        """KV refill bytes a request owes before decoding (0.0 when
        residency untracked)."""
        return (self.kv_refill_bytes[request]
                if request < len(self.kv_refill_bytes) else 0.0)

    def remaining_prompt(self, request: int) -> int:
        """Prompt tokens of ``request`` still to prefill."""
        done = (self.prefill_progress[request]
                if request < len(self.prefill_progress) else 0)
        return max(0, self.prompt_lengths[request] - done)

    def decode_owed(self, request: int) -> int:
        """Decode iterations ``request`` is still owed."""
        done = (self.decode_done[request]
                if request < len(self.decode_done) else 0)
        return max(0, self.max_new_tokens - done)

    def carryover(self) -> "list[tuple[int, int]]":
        """``[(request id, decode iterations owed)]`` for requests whose
        prefill already completed in an earlier epoch but still owe
        decode — the preempted/resumed decode streams every policy must
        reschedule *before* (or interleaved with) fresh prefill work."""
        return [(r, self.decode_owed(r))
                for r in range(len(self.prompt_lengths))
                if self.remaining_prompt(r) == 0 and self.decode_owed(r) > 0]

    @property
    def n_layers(self) -> int:
        return self.cfg.n_layers

    def batches(self) -> "list[tuple[tuple[int, ...], int]]":
        """Padded batch chunks in queue order: ``[(request ids, S_padded)]``
        — the same chunking every policy (and the pre-refactor ``plan``)
        uses, so policies differ only in *when* steps run.  Requests
        with no prompt tokens left (online carryover) are excluded;
        partially-prefilled requests are padded to their *remaining*
        length — the work a re-plan actually schedules."""
        out = []
        todo = [(r, self.remaining_prompt(r))
                for r in range(len(self.prompt_lengths))
                if self.remaining_prompt(r) > 0]
        while todo:
            chunk, todo = todo[: self.max_batch], todo[self.max_batch:]
            out.append((tuple(r for r, _ in chunk),
                        max(s for _, s in chunk)))
        return out


POLICIES: "dict[str, type]" = {}


def register_policy(cls):
    """Class decorator: add a :class:`SchedulingPolicy` to the registry
    under its ``name``."""
    name = cls.name
    prev = POLICIES.get(name)
    if prev is not None and prev is not cls:
        raise ValueError(f"policy {name!r} already registered by "
                         f"{prev.__name__}")
    POLICIES[name] = cls
    return cls


def available_policies() -> "tuple[str, ...]":
    return tuple(POLICIES)


def get_policy(name: str, **kw) -> "SchedulingPolicy":
    try:
        cls = POLICIES[name]
    except KeyError:
        raise KeyError(f"unknown scheduling policy {name!r}; one of "
                       f"{sorted(POLICIES)} (or 'auto')") from None
    return cls(**kw)


class SchedulingPolicy(abc.ABC):
    """One batching policy: queue in, :class:`BatchSchedule` out.

    Subclasses implement :meth:`schedule`; the shared helpers
    (``_emit`` / ``_finish``) keep every policy on the common
    ``BatchStep``/``LayerTrace`` lowering path and stamp the
    context's arrival times onto the schedule as per-step release
    times, so arrival semantics and overlap modes work for any
    registered policy without per-policy code.
    """

    name: str = "abstract"
    #: meta-policies (e.g. ``auto-slo``) wrap the candidate sweep rather
    #: than lowering a schedule shape of their own; the default sweep
    #: skips them so a sweep can never recurse into itself.
    meta: bool = False

    @abc.abstractmethod
    def schedule(self, ctx: PolicyContext):
        """Lower ``ctx`` into a :class:`~repro_torch.serving.engine
        .BatchSchedule` (policy / affinity / arrival-derived release
        fields filled in)."""

    # ----- shared lowering helpers -----------------------------------------
    def _emit(self, steps, layers, ctx, kind, name, requests, tokens,
              repeat, decode_requests=()):
        from repro_torch.serving.engine import BatchStep, _step_layer
        steps.append(BatchStep(kind, tuple(requests), tokens=tokens,
                               repeat=repeat,
                               decode_requests=tuple(decode_requests)))
        layers.append(_step_layer(ctx.cfg, name, tokens, repeat))

    def _finish(self, steps, layers, ctx, affinity=None):
        from repro_torch.serving.engine import BatchSchedule
        release = ()
        if ctx.arrival_times:
            # a padded batch step cannot form before its last request
            # arrives; decode/mixed steps inherit the same bound (their
            # hazard deps dominate it in practice).
            release = tuple(
                max((ctx.arrival_of(r) for r in s.requests), default=0.0)
                for s in steps)
        refill = ()
        if any(ctx.kv_refill_bytes):
            # a request's owed KV refill is paid once, on the first step
            # that touches it — after that its blocks are hot for the
            # rest of the plan.  The lowering turns nonzero step refill
            # into a real ``memory`` node the DES/analytical forms price.
            owed = {r: ctx.refill_of(r)
                    for r in range(len(ctx.prompt_lengths))
                    if ctx.refill_of(r) > 0.0}
            per_step = []
            for s in steps:
                per_step.append(sum(owed.pop(r, 0.0) for r in s.requests))
            refill = tuple(per_step)
        return BatchSchedule(steps, layers, units=ctx.units,
                             policy=self.name,
                             affinity=dict(affinity or {}),
                             arrival_times=tuple(ctx.arrival_times),
                             release_times=release,
                             refill_bytes=refill)

    def _carryover_inflight(self, ctx: PolicyContext) -> "list[_InFlight]":
        """Online carryover as in-flight decode entries: requests whose
        prefill completed in an earlier epoch, grouped by owed decode
        count so the round-robin collapse stays merged.  Empty for the
        classic one-shot context."""
        by_owed: "dict[int, list[int]]" = {}
        for r, owed in ctx.carryover():
            by_owed.setdefault(owed, []).append(r)
        return [_InFlight(ci=-1, ids=tuple(ids), left=owed,
                          label=f"carry{owed}")
                for owed, ids in sorted(by_owed.items())]

    def _split_by_residency(self, ctx, inflight):
        """Partition in-flight decode entries into (hot, cold) by the
        context's KV residency: a request owing refill bytes is cold.
        Entries mixing both split into two, name-tagged ``.hot`` /
        ``.cold`` so the step labels stay unique."""
        hot, cold = [], []
        for d in inflight:
            h = tuple(i for i in d.ids if ctx.refill_of(i) <= 0.0)
            c = tuple(i for i in d.ids if ctx.refill_of(i) > 0.0)
            if h and not c:
                hot.append(d)
            elif c and not h:
                cold.append(d)
            else:
                if h:
                    hot.append(_InFlight(d.ci, h, d.left, d.tag + ".hot"))
                if c:
                    cold.append(_InFlight(d.ci, c, d.left, d.tag + ".cold"))
        return hot, cold

    def _drain_round_robin(self, steps, layers, ctx, inflight):
        """Fair round-robin drain of everything still owing decode
        iterations, collapsed into one merged step per distinct horizon
        (every in-flight batch advances one token per round)."""
        while inflight:
            m = min(d.left for d in inflight)
            ids = tuple(i for d in inflight for i in d.ids)
            tag = "+".join(d.tag for d in inflight)
            self._emit(steps, layers, ctx, "decode", f"{tag}/decode.rr",
                       ids, tokens=len(ids), repeat=ctx.n_layers * m,
                       decode_requests=ids)
            for d in inflight:
                d.left -= m
            inflight[:] = [d for d in inflight if d.left > 0]


# ---------------------------------------------------------------------------
# The three built-in policies.
# ---------------------------------------------------------------------------

@register_policy
class FullPrefillPolicy(SchedulingPolicy):
    """The pre-refactor ``ServingEngine.plan`` behaviour, verbatim: per
    padded batch one prefill step over ``B × S_padded`` tokens, then all
    ``max_new_tokens`` decode iterations collapsed into one lockstep
    step.  Schedules are bit-identical to the old inline policy (pinned
    by ``tests/test_scheduler.py``).  Online carryover (decode streams
    resumed from an earlier epoch) drains first, lockstep — finishing
    interrupted streams before new prefill is this policy's creed."""

    name = "full-prefill"

    def schedule(self, ctx: PolicyContext):
        steps, layers = [], []
        self._drain_round_robin(steps, layers, ctx,
                                self._carryover_inflight(ctx))
        for ci, (ids, s) in enumerate(ctx.batches()):
            b = len(ids)
            self._emit(steps, layers, ctx, "prefill", f"b{ci}/prefill",
                       ids, tokens=b * s, repeat=ctx.n_layers)
            self._emit(steps, layers, ctx, "decode", f"b{ci}/decode",
                       ids, tokens=b,
                       repeat=ctx.n_layers * ctx.max_new_tokens)
        return self._finish(steps, layers, ctx)


@dataclasses.dataclass
class _InFlight:
    ci: int
    ids: "tuple[int, ...]"
    left: int                        # decode iterations still owed
    label: str = ""                  # step-name tag ("": derive from ci)

    @property
    def tag(self) -> str:
        return self.label or f"b{self.ci}"


class _ChunkingPolicy(SchedulingPolicy):
    """Shared machinery for the chunk-interleaving policies."""

    def __init__(self, chunk_tokens: int = 256):
        if chunk_tokens < 1:
            raise ValueError(f"chunk_tokens must be >= 1, "
                             f"got {chunk_tokens}")
        self.chunk_tokens = chunk_tokens

    def _chunks(self, total: int) -> "list[int]":
        n = max(1, math.ceil(total / self.chunk_tokens))
        return [min(self.chunk_tokens, total - j * self.chunk_tokens)
                for j in range(n)]


@register_policy
class ChunkedPrefillPolicy(_ChunkingPolicy):
    """Chunked prefill with piggybacked decode (Sarathi-style): each
    scheduling step is one ``chunk_tokens`` slice of the current prompt
    *plus* one decode iteration for every request already decoding — one
    mixed batch through the model, so prefill of later batches overlaps
    decode of earlier ones without dedicated decode slots."""

    name = "chunked-prefill"

    def schedule(self, ctx: PolicyContext):
        steps, layers = [], []
        # online carryover decode streams piggyback from the first chunk
        inflight: "list[_InFlight]" = self._carryover_inflight(ctx)
        for ci, (ids, s) in enumerate(ctx.batches()):
            b = len(ids)
            for j, chunk in enumerate(self._chunks(b * s)):
                riders = [d for d in inflight if d.left > 0]
                rider_ids = tuple(i for d in riders for i in d.ids)
                kind = "mixed" if riders else "prefill"
                self._emit(
                    steps, layers, ctx, kind,
                    f"b{ci}/{kind}.c{j}", ids + rider_ids,
                    tokens=chunk + len(rider_ids), repeat=ctx.n_layers,
                    decode_requests=rider_ids)
                for d in riders:
                    d.left -= 1
                inflight = [d for d in inflight if d.left > 0]
            inflight.append(_InFlight(ci, ids, ctx.max_new_tokens))
        self._drain_round_robin(steps, layers, ctx, inflight)
        return self._finish(steps, layers, ctx)


@register_policy
class DecodePriorityPolicy(_ChunkingPolicy):
    """Decode-priority interleaving: every scheduling round runs one
    merged decode iteration of everything in flight *before* the next
    prefill chunk — decode work preempts prefill at layer granularity
    (a decode step's layers slot between the chunk's layers rather than
    behind the whole prompt), so a request starts decoding as soon as
    its own prefill lands instead of waiting out earlier batches'
    drains.  On a cluster the policy hints the latency-critical decode
    stream onto unit 0 for the ``unit-affinity`` partition strategy
    (list the fastest unit first in a heterogeneous topology); prefill
    GEMMs stay unhinted so the partitioner balances them over every
    unit.

    With KV residency threaded through the context
    (``ctx.kv_residency`` — see :mod:`repro_torch.serving.kvcache`) and
    ``residency_aware`` on (the default), the carried-over decode
    streams are served **hot-first**: requests whose KV blocks are all
    resident drain before any cold stream's refill is waited out, so
    hot first-token latencies stop paying for other requests' evicted
    blocks.  The cold streams still pay their refill (stamped onto
    their first step and priced as a memory node) — the policy moves
    the refill out of the hot requests' critical path, it never hides
    it.  ``residency_aware=False`` is the residency-blind twin: same
    physics, one merged drain that makes everyone wait out the refill.
    """

    name = "decode-priority"

    def __init__(self, chunk_tokens: int = 256,
                 residency_aware: bool = True):
        super().__init__(chunk_tokens)
        self.residency_aware = residency_aware

    def schedule(self, ctx: PolicyContext):
        steps, layers = [], []
        affinity: "dict[str, int]" = {}
        # online carryover preempts the very first prefill chunk
        inflight: "list[_InFlight]" = self._carryover_inflight(ctx)
        if self.residency_aware and any(ctx.kv_refill_bytes):
            hot, cold = self._split_by_residency(ctx, inflight)
            if hot and cold:
                # hot streams drain to completion first; cold streams
                # re-enter the normal preemption flow behind them and
                # pay their refill there.
                self._drain_round_robin(steps, layers, ctx, hot)
                inflight = cold
        rr = 0

        def emit_decode(name, rid, repeat):
            self._emit(steps, layers, ctx, "decode", name, rid,
                       tokens=len(rid), repeat=repeat,
                       decode_requests=rid)
            # the hint covers decode steps *competing* with prefill
            # chunks; the tail drain (_drain_round_robin) has the
            # cluster to itself and is left to the partitioner's
            # balancer.
            if ctx.units > 1:
                affinity[name] = 0

        for ci, (ids, s) in enumerate(ctx.batches()):
            b = len(ids)
            for j, chunk in enumerate(self._chunks(b * s)):
                riders = [d for d in inflight if d.left > 0]
                if riders:
                    rid = tuple(i for d in riders for i in d.ids)
                    emit_decode(f"dp{rr}/decode", rid, ctx.n_layers)
                    rr += 1
                    for d in riders:
                        d.left -= 1
                    inflight = [d for d in inflight if d.left > 0]
                self._emit(steps, layers, ctx, "prefill",
                           f"b{ci}/prefill.c{j}", ids, tokens=chunk,
                           repeat=ctx.n_layers)
            inflight.append(_InFlight(ci, ids, ctx.max_new_tokens))
        self._drain_round_robin(steps, layers, ctx, inflight)
        return self._finish(steps, layers, ctx, affinity)


# ---------------------------------------------------------------------------
# Pricing: per-step costs -> serving latency metrics.
# ---------------------------------------------------------------------------

def backend_kwargs_for(sched, default_strategy: str = "output-tile",
                       **overrides) -> dict:
    """Backend-constructor kwargs a schedule implies: its cluster width,
    its auto-chosen partition strategy (or ``unit-affinity`` when the
    policy emitted placement hints, else ``default_strategy`` —
    serving GEMMs are short and wide, so ``output-tile`` shards the
    dimension that actually spreads work).  Explicit ``overrides``
    win."""
    kw = dict(overrides)
    if sched.units > 1:
        kw.setdefault("units", sched.units)
        strat = kw.setdefault("strategy", sched.strategy
                              or ("unit-affinity" if sched.affinity
                                  else default_strategy))
        if strat == "unit-affinity" and sched.affinity:
            kw.setdefault("affinity", dict(sched.affinity))
    return kw


#: memoised per-step prices: a serving sweep re-prices the same
#: (layer shape × backend config) hundreds of times — decode steps of
#: one schedule share a shape, and ``select_schedule`` prices every
#: (policy × strategy × overlap) candidate.  Keyed by the backend's
#: resolved constructor kwargs and the layer's full cost signature, so
#: a hit is exact by construction; hit/miss totals land in the obs
#: registry (``price_cache_{hits,misses}_total``) when it is enabled.
_PRICE_CACHE: "dict[tuple, dict]" = {}
_PRICE_CACHE_MAX = 4096


def _layer_price_key(lt, sched, backend_name: str, kw: dict,
                     release: float = 0.0, refill: float = 0.0) -> tuple:
    """Cache key of one step's price: everything its cost can depend on.
    ``LayerTrace``/``MatMulTask`` are dataclasses with content reprs;
    the step *name* only matters when the partition affinity hints it
    somewhere, so unhinted same-shape steps share an entry.

    The schedule's ``overlap`` mode and the step's ``release`` time are
    part of the key: today's per-step ``run_workload`` pricing is
    arrival- and overlap-independent, but the cache contract is "a hit
    is exact by construction" — the online loop re-prices the *same
    shapes* under shifted arrivals every admission epoch, and a backend
    that starts charging release gaps or cross-step contention into
    step costs must never alias a stale entry (pinned by
    ``tests/test_online.py``).  ``refill`` — the step's owed KV refill
    bytes — is part of the key for the same reason: a step's price
    includes its refill memory traffic, so the same shape under
    different residency must never alias."""
    hinted = lt.name if lt.name in (sched.affinity or {}) else None
    return (backend_name, repr(sorted(kw.items())), hinted,
            sched.overlap, release, refill,
            tuple(repr(g) for g in lt.gemms),
            tuple(sorted(lt.vector_ops.items())),
            lt.intermediate_bytes, lt.repeat)


def clear_price_cache() -> None:
    _PRICE_CACHE.clear()


def _price_workloads(sched, backend_name: str,
                     **backend_kwargs) -> "list[dict]":
    """Per-step ``run_workload`` dicts on a modelling backend (repeat
    included) — one pricing pass feeding both the latency timeline and
    the aggregate utilization.  Prices are memoised per (backend config
    × step cost signature); the modelling backends are deterministic,
    so a hit returns the identical dict."""
    from repro_torch import backend
    from repro_torch.obs import default_registry
    kw = backend_kwargs_for(sched, **backend_kwargs)
    eng = None
    reg = default_registry()
    out: "list[dict]" = []
    rel = list(sched.release_times) or [0.0] * len(sched.layers)
    refills = list(getattr(sched, "refill_bytes", ()) or ())
    refills += [0.0] * (len(sched.layers) - len(refills))
    for lt, release, refill in zip(sched.layers, rel, refills):
        key = _layer_price_key(lt, sched, backend_name, kw, release, refill)
        w = _PRICE_CACHE.get(key)
        if w is None:
            reg.counter("price_cache_misses_total",
                        backend=backend_name).inc()
            if eng is None:
                eng = backend.get(backend_name, **kw)
                if not eng.models_time:
                    raise ValueError(f"backend {backend_name!r} does not "
                                     "model time")
            w = eng.run_workload([lt])
            if refill > 0.0:
                # the step's KV refill rides the shared loader before
                # its tiles — the same memory-node price the lowered
                # graph carries, added serially here so per-step
                # pricing and the full-graph DES/analytical forms see
                # the same cost.
                from repro_torch.serving.kvcache import refill_cycles
                extra = refill_cycles(refill, eng.unit, eng.platform,
                                      units=sched.units)
                w = dict(w, cycles=w["cycles"] + extra,
                         kv_refill_cycles=extra)
            if len(_PRICE_CACHE) >= _PRICE_CACHE_MAX:
                _PRICE_CACHE.clear()
            _PRICE_CACHE[key] = w
        else:
            reg.counter("price_cache_hits_total",
                        backend=backend_name).inc()
        out.append(dict(w))
    return out


def price_steps(sched, backend_name: str = "analytical",
                **backend_kwargs) -> "list[float]":
    """Cycles of each schedule step on a modelling backend (repeat
    included) — the timeline ``decode_latency_stats`` consumes.  Cluster
    backends (``units > 1``) price each step sharded across the
    schedule's units; the contention-aware ``analytical`` form does so
    without running the DES."""
    return [w["cycles"]
            for w in _price_workloads(sched, backend_name,
                                      **backend_kwargs)]


def _percentile(xs: "list[float]", q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); 0.0 on empty input."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[min(rank, len(xs)) - 1]


def _effective_strategy(sched) -> str:
    """The partition strategy pricing actually uses for ``sched`` — the
    same resolution order as :func:`backend_kwargs_for`."""
    return sched.strategy or ("unit-affinity" if sched.affinity
                              else "output-tile")


def schedule_timeline(sched,
                      step_cycles: "list[float]",
                      ) -> "list[tuple[float, float]]":
    """Per-step ``(start, end)`` cycles of a priced schedule — the
    first-order timeline :func:`decode_latency_stats` consumes.

    ``overlap="chained"`` (and every single-unit schedule): steps run
    serially, each waiting out its release time first — exactly the
    classic cumulative walk when arrivals are all zero.

    ``overlap="relaxed"`` on a multi-unit ``unit-affinity`` schedule:
    a step starts at the latest of its release time, its hazard deps'
    (:meth:`~repro_torch.serving.engine.BatchSchedule.step_deps`) completions,
    and the free time of the units it occupies — a step with an affinity
    hint occupies that unit alone, unhinted steps occupy the remaining
    (un-hinted) units, so a pinned decode stream runs beside prefill
    chunks the way the partitioner lays them out.  This is a list-
    schedule approximation (each step is still priced at its backend
    cost); the DES on the relaxed graph is the ground truth it tracks.
    """
    if len(step_cycles) != len(sched.steps):
        raise ValueError(f"{len(step_cycles)} step prices for "
                         f"{len(sched.steps)} steps")
    n = len(sched.steps)
    rel = list(sched.release_times) or [0.0] * n
    relaxed = (sched.overlap == "relaxed" and sched.units > 1
               and _effective_strategy(sched) == "unit-affinity"
               and sched.affinity)
    if not relaxed:
        spans = []
        t = 0.0
        for r, cyc in zip(rel, step_cycles):
            start = max(t, r)
            t = start + cyc
            spans.append((start, t))
        return spans

    deps = sched.step_deps()
    hinted = set(sched.affinity.values())
    rest = [u for u in range(sched.units) if u not in hinted] \
        or list(range(sched.units))
    free = [0.0] * sched.units
    end: "list[float]" = [0.0] * n
    spans = []
    for j, (step, cyc) in enumerate(zip(sched.steps, step_cycles)):
        hint = sched.affinity.get(sched.layers[j].name)
        occupies = [hint] if hint is not None else rest
        start = max([rel[j]] + [end[d] for d in deps[j]]
                    + [free[u] for u in occupies])
        end[j] = start + cyc
        for u in occupies:
            free[u] = end[j]
        spans.append((start, end[j]))
    return spans


def schedule_spans(sched, step_cycles: "list[float]", n_layers: int):
    """The per-request lifecycle :class:`~repro_torch.obs.spans.SpanLog` of a
    priced schedule, placed on the same :func:`schedule_timeline` that
    :func:`decode_latency_stats` uses — ``arrival → admission →
    prefill(.chunk_j) → decode_iter_k → complete`` for every request,
    without running the DES (``evaluate_schedule`` attaches the
    DES-grounded log under ``result.detail["span_log"]``)."""
    from repro_torch.obs import SpanLog
    return SpanLog.from_schedule(sched, schedule_timeline(sched, step_cycles),
                                 n_layers)


def decode_latency_stats(sched, step_cycles: "list[float]",
                         n_layers: int) -> "dict[str, float]":
    """Serving metrics from a priced schedule.

    Steps are placed on the :func:`schedule_timeline` (serial for
    chained schedules, hazard/unit-constrained for relaxed multi-unit
    ones; release times from request arrivals either way); a step
    covering ``repeat / n_layers`` decode iterations emits its tokens
    uniformly across its span.  Reported:

    * ``ttft_p50`` / ``ttft_p99`` — per-request **time to first token**:
      from the request's own arrival to its first decode token (the
      queueing delay a batching policy controls; full prefill makes
      later batches wait out every earlier drain).  With an all-at-t=0
      queue this equals the classic decode-queueing delay.
    * ``decode_p50`` / ``decode_p99`` — same values, kept under the
      pre-arrival-semantics names every existing caller uses.
    * ``itl_p50`` / ``itl_p99`` — inter-token latency between successive
      decode tokens of one request (the cadence cost of interleaving).
    * ``makespan`` — cycles until the last step completes (strictly
      below the serial sum when relaxed overlap genuinely overlaps).
    """
    spans = schedule_timeline(sched, step_cycles)
    first: "dict[int, float]" = {}
    last: "dict[int, float]" = {}
    itl: "list[float]" = []
    for step, (start, end) in zip(sched.steps, spans):
        dr = step.decode_requests or (
            step.requests if step.kind == "decode" else ())
        if dr:
            iters = max(1, round(step.repeat / n_layers))
            for j in range(iters):
                tok = start + (end - start) * (j + 1) / iters
                for r in dr:
                    if r in last:
                        itl.append(tok - last[r])
                    else:
                        first[r] = tok
                    last[r] = tok
    lat = [t - sched.arrival_of(r) for r, t in first.items()]
    ttft = {
        "ttft_p50": _percentile(lat, 50.0),
        "ttft_p99": _percentile(lat, 99.0),
    }
    return {
        "makespan": max((e for _, e in spans), default=0.0),
        "decode_p50": ttft["ttft_p50"],
        "decode_p99": ttft["ttft_p99"],
        **ttft,
        "itl_p50": _percentile(itl, 50.0),
        "itl_p99": _percentile(itl, 99.0),
        "decode_tokens": float(len(itl) + len(first)),
    }


def schedule_metrics(sched, n_layers: int,
                     backend_name: str = "analytical",
                     **backend_kwargs) -> "dict[str, float]":
    """One-call pricing: per-step costs + latency stats + aggregate
    matrix utilization of the whole schedule on ``backend_name`` — one
    ``run_workload`` pass per step, shared by both.  An explicit
    ``strategy=`` override reaches the latency timeline too, so the
    relaxed-overlap placement model always matches the partition the
    steps were actually priced under."""
    works = _price_workloads(sched, backend_name, **backend_kwargs)
    cycles = [w["cycles"] for w in works]
    resolved = backend_kwargs_for(sched, **backend_kwargs).get("strategy")
    if resolved is not None and resolved != sched.strategy:
        sched = dataclasses.replace(sched, strategy=resolved)
    stats = decode_latency_stats(sched, cycles, n_layers)
    total = sum(cycles)
    # the single-unit simulate_workload reports busy matrix cycles, the
    # cluster forms report per-layer utilization directly; either way
    # the schedule aggregate is the cycle-weighted mean.
    busy = sum(w.get("matrix_utilization",
                     w["matrix"] / c if c else 0.0) * c
               for w, c in zip(works, cycles))
    stats["matrix_utilization"] = busy / total if total else 0.0
    stats["workload_cycles"] = total
    return stats


# ---------------------------------------------------------------------------
# Auto-selection: price (policy x partition) candidates, pick the best.
# ---------------------------------------------------------------------------

def select_schedule(ctx: PolicyContext, *,
                    backend_name: str = "analytical",
                    objective: str = "decode_p50",
                    makespan_slack: float = 0.05,
                    policies: "Optional[list[str]]" = None,
                    strategies: "Optional[list[str]]" = None,
                    overlaps: "Optional[list[str]]" = None,
                    policy_kw: "Optional[dict]" = None,
                    ttft_p99_slo: "Optional[float]" = None,
                    **backend_kwargs):
    """Price every (policy × partition strategy × overlap) candidate
    with the closed-form ``analytical`` backend (no DES run) and return
    ``(best BatchSchedule, report)``.

    Objective: minimise ``objective`` (a :func:`decode_latency_stats`
    key) among candidates whose makespan is within ``makespan_slack`` of
    the fastest candidate — latency policies may not buy their p50 with
    unbounded throughput loss.  On a cluster the sweep includes
    ``overlap="relaxed"`` lowering (true data hazards only), so a
    relaxed-overlap candidate is picked exactly when the overlap lowers
    the objective; single-unit sweeps stay chained (relaxed cannot
    overlap anything there).  ``policy_kw`` (e.g. ``chunk_tokens``)
    is forwarded to every candidate policy that accepts it.  ``report``
    maps candidate keys to their metric dicts (chained candidates keep
    the bare ``policy×strategy`` key; relaxed ones append
    ``×relaxed``), the chosen one repeated under ``"chosen"``.

    ``ttft_p99_slo`` (cycles) switches to **SLO selection** — the
    ``auto-slo`` policy's rule: among candidates whose ``ttft_p99``
    meets the target, pick the *cheapest* (lowest ``workload_cycles``,
    makespan tie-break) regardless of the slack rule; when *no*
    candidate meets the target, degrade gracefully to the candidate
    closest to it (lowest ``ttft_p99``).  ``report["chosen"]["slo_met"]``
    records which branch fired.

    The default sweep covers every registered *concrete* policy;
    meta-policies (``SchedulingPolicy.meta``) are skipped so the sweep
    cannot recurse into the policy that invoked it.
    """
    names = list(policies if policies is not None else
                 [n for n, c in POLICIES.items()
                  if not getattr(c, "meta", False)])
    strats = list(strategies or
                  (["output-tile", "unit-affinity"] if ctx.units > 1
                   else [None]))
    ovs = list(overlaps or
               (["chained", "relaxed"] if ctx.units > 1 else ["chained"]))
    from repro_torch.sim.lower import OVERLAP_MODES
    bad = [ov for ov in ovs if ov not in OVERLAP_MODES]
    if bad:
        raise ValueError(f"unknown overlap mode(s) {bad}; "
                         f"one of {OVERLAP_MODES}")
    cands: "dict[str, tuple]" = {}
    for pname in names:
        try:
            policy = get_policy(pname, **(policy_kw or {}))
        except TypeError:          # e.g. chunk_tokens on full-prefill
            policy = get_policy(pname)
        base = policy.schedule(ctx)
        for strat in strats:
            for ov in ovs:
                sched = dataclasses.replace(base, strategy=strat,
                                            overlap=ov)
                if ov == "relaxed" and not (
                        _effective_strategy(sched) == "unit-affinity"
                        and sched.affinity):
                    # identical metrics to the chained twin (the relaxed
                    # timeline only differs under hinted unit-affinity
                    # placement) — don't pay a second pricing pass.
                    continue
                kw = dict(backend_kwargs)
                if ctx.units > 1:
                    kw["units"] = ctx.units
                m = schedule_metrics(sched, ctx.n_layers, backend_name,
                                     **kw)
                key = (f"{pname}" + (f"×{strat}" if strat else "")
                       + (f"×{ov}" if ov != "chained" else ""))
                cands[key] = (sched, m)
    if not cands:
        raise ValueError(
            "no priceable candidates: overlap='relaxed' only differs "
            "under a hint-emitting policy with the 'unit-affinity' "
            "strategy — include 'chained' in overlaps or widen the sweep")
    slo_met = None
    if ttft_p99_slo is not None:
        meeting = {k: v for k, v in cands.items()
                   if v[1]["ttft_p99"] <= ttft_p99_slo}
        slo_met = bool(meeting)
        if meeting:                  # cheapest candidate meeting the SLO
            key = min(meeting, key=lambda k: (
                meeting[k][1]["workload_cycles"],
                meeting[k][1]["makespan"]))
        else:                        # none can: closest to the target
            key = min(cands, key=lambda k: (cands[k][1]["ttft_p99"],
                                            cands[k][1]["makespan"]))
        sched, metrics = cands[key]
    else:
        best_makespan = min(m["makespan"] for _, m in cands.values())
        feasible = {k: v for k, v in cands.items()
                    if v[1]["makespan"]
                    <= (1 + makespan_slack) * best_makespan}
        key = min(feasible, key=lambda k: (feasible[k][1][objective],
                                           feasible[k][1]["makespan"]))
        sched, metrics = feasible[key]
    report = {k: m for k, (_, m) in cands.items()}
    report["chosen"] = dict(metrics, candidate=key)
    if slo_met is not None:
        report["chosen"]["slo_met"] = slo_met
    return sched, report


# ---------------------------------------------------------------------------
# SLO-aware meta-policy: cheapest candidate meeting a p99 TTFT target.
# ---------------------------------------------------------------------------

@register_policy
class AutoSLOPolicy(SchedulingPolicy):
    """``policy="auto-slo"``: run the full (policy × partition ×
    overlap) candidate sweep and pick the **cheapest** candidate
    (lowest ``workload_cycles``) whose analytical ``ttft_p99`` meets
    ``ttft_p99_target`` — serve the SLO, spend nothing beyond it.  When
    no candidate can meet the target the policy degrades gracefully to
    the candidate closest to it; with no target at all it reduces to
    the classic slack-bounded ``objective`` selection ("auto").

    A *meta*-policy: it owns no schedule shape, so the sweep it invokes
    skips it (``meta = True``) and the returned schedule keeps the
    winning concrete policy's name, affinity and overlap.  The sweep's
    full pricing report is kept on :attr:`last_report` for callers (the
    online loop logs the chosen candidate per admission epoch)."""

    name = "auto-slo"
    meta = True

    def __init__(self, ttft_p99_target: "Optional[float]" = None,
                 backend_name: str = "analytical",
                 objective: str = "decode_p50",
                 makespan_slack: float = 0.05,
                 policies: "Optional[list[str]]" = None,
                 strategies: "Optional[list[str]]" = None,
                 overlaps: "Optional[list[str]]" = None,
                 policy_kw: "Optional[dict]" = None,
                 **backend_kwargs):
        self.ttft_p99_target = ttft_p99_target
        self.backend_name = backend_name
        self.objective = objective
        self.makespan_slack = makespan_slack
        self.policies = policies
        self.strategies = strategies
        self.overlaps = overlaps
        self.policy_kw = policy_kw
        self.backend_kwargs = backend_kwargs
        self.last_report: "Optional[dict]" = None

    def schedule(self, ctx: PolicyContext):
        sched, report = select_schedule(
            ctx, backend_name=self.backend_name, objective=self.objective,
            makespan_slack=self.makespan_slack, policies=self.policies,
            strategies=self.strategies, overlaps=self.overlaps,
            policy_kw=self.policy_kw, ttft_p99_slo=self.ttft_p99_target,
            **self.backend_kwargs)
        self.last_report = report
        return sched
