"""Online closed-loop serving: streaming admission + incremental re-plans.

``ServingEngine.plan`` is an offline one-shot — the whole queue is known
at t = 0, one schedule is built, priced, executed.  Production traffic
*keeps arriving*; this module closes the loop:

* an arrival process (:mod:`repro_torch.serving.arrivals`) feeds requests to
  :class:`OnlineServingEngine.run`;
* the loop runs in **admission epochs**: at each epoch it admits every
  request that has arrived, re-plans the whole in-flight set through the
  registered batching policies (``policy="auto-slo"`` sweeps policy ×
  partition × overlap via :func:`~repro_torch.serving.scheduler
  .select_schedule`, priced by the contention-aware analytical closed
  form — cheap enough to re-price on every admission, and the pricing
  cache makes repeat shapes free), then **commits** only the prefix of
  steps that start before the next arrival (at least one step — the
  admission-epoch granularity is a scheduling *step*, the chunk/layer
  granularity the decoupled-ISA argument buys, not a whole request
  drain);
* each committed epoch executes through the same
  ``ServingEngine.run_schedule`` DES path the offline planner uses, so
  spans and metrics stay grounded in measured per-resource timelines;
* requests cut mid-decode by a re-plan are **preempted** — their
  ``(prefill_progress, decode_done)`` state re-enters the next plan via
  :class:`~repro_torch.serving.scheduler.PolicyContext` carryover, and the
  resumed stream continues at ``decode_iter<k>`` in the global span log;
  a bounded in-flight set (``max_inflight`` + ``evict_to_admit``)
  additionally **evicts** the least-progressed decode stream back to
  the waiting queue, state retained, when fresh arrivals would
  otherwise starve.

Progress bookkeeping is *padded-token* accounting: a committed prefill
or mixed step advances each prefill participant by
``ceil(prefill_tokens / participants)`` of the padded batch stream,
capped at its remaining prompt.  This is exact for ``full-prefill``
(every step covers the batch's whole padded prompt) and for the
single-request epochs a low offered load produces; under heterogeneous
batches it credits padding to the shorter prompts — an over-approx that
only makes a request *eligible* to decode earlier, never drops work.

:class:`OnlineResult` carries the closed-loop serving metrics — TTFT /
ITL percentiles measured on the global clock from each request's true
arrival, goodput (completed requests per second, optionally only those
meeting a TTFT SLO), preemption/eviction counts — plus the per-epoch
records and a cross-epoch :class:`~repro_torch.obs.SpanLog` whose
``validate()`` holds through preemption and eviction.
:func:`qps_sweep` and :func:`find_saturation` are the sustained-load
benches built on top.  A copy of the reference's
``repro/serving/online.py``; it plans and prices, and executes nothing on
the card.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Iterable, Optional

#: horizon/arrival comparison slack (cycles) — float noise, not policy.
_EPS = 1e-9


@dataclasses.dataclass
class OnlineRequest:
    """One request's closed-loop state, carried across re-plans."""

    rid: int
    arrival: float
    prompt_len: int
    prefill_done: int = 0
    decode_done: int = 0
    admitted: "Optional[float]" = None     # first admission epoch clock
    finish: "Optional[float]" = None       # last owned step's end (global)
    preemptions: int = 0
    evictions: int = 0

    def done(self, max_new_tokens: int) -> bool:
        return (self.prefill_done >= self.prompt_len
                and self.decode_done >= max_new_tokens)


@dataclasses.dataclass
class EpochRecord:
    """What one admission epoch planned, committed, and executed."""

    index: int
    clock: float                   # epoch start, global cycles
    makespan: float                # committed sub-schedule's DES makespan
    admitted: "tuple[int, ...]"    # request ids admitted this epoch
    committed_steps: int           # steps executed ...
    planned_steps: int             # ... of the full re-plan
    policy: str                    # concrete policy of the (chosen) plan
    strategy: "Optional[str]"
    overlap: str
    preempted: "tuple[int, ...]" = ()
    evicted: "tuple[int, ...]" = ()
    candidate: "Optional[str]" = None   # auto-slo sweep's chosen key
    slo_met: "Optional[bool]" = None


@dataclasses.dataclass
class OnlineResult:
    """The closed-loop run: per-request outcomes, per-epoch records,
    the cross-epoch span log, and the serving metrics derived from
    them."""

    requests: "list[OnlineRequest]"
    epochs: "list[EpochRecord]"
    span_log: object               # repro_torch.obs.SpanLog
    makespan: float                # global clock at drain, cycles
    max_new_tokens: int
    freq_hz: float

    # ----- latency ---------------------------------------------------------
    def ttfts(self) -> "dict[int, float]":
        """Per-request time to first token (cycles, from true arrival)."""
        out = {}
        for r in self.requests:
            try:
                out[r.rid] = self.span_log.ttft(r.rid)
            except KeyError:
                pass                        # never decoded (shouldn't happen)
        return out

    def itls(self) -> "list[float]":
        """Inter-token gaps between successive decode tokens, pooled."""
        ends: "dict[int, list[float]]" = {}
        for s in self.span_log:
            if s.phase.startswith("decode_iter"):
                ends.setdefault(s.request, []).append(s.end)
        gaps: "list[float]" = []
        for ts in ends.values():
            ts.sort()
            gaps.extend(b - a for a, b in zip(ts, ts[1:]))
        return gaps

    def ttft_stats(self) -> "dict[str, float]":
        from repro_torch.serving.scheduler import _percentile
        lat = list(self.ttfts().values())
        itl = self.itls()
        return {"ttft_p50": _percentile(lat, 50.0),
                "ttft_p99": _percentile(lat, 99.0),
                "itl_p50": _percentile(itl, 50.0),
                "itl_p99": _percentile(itl, 99.0)}

    # ----- throughput ------------------------------------------------------
    def completed(self, ttft_slo: "Optional[float]" = None,
                  ) -> "list[OnlineRequest]":
        """Requests that finished — optionally only those whose TTFT met
        ``ttft_slo`` (cycles): the *goodput* numerator."""
        done = [r for r in self.requests if r.finish is not None]
        if ttft_slo is None:
            return done
        t = self.ttfts()
        return [r for r in done
                if r.rid in t and t[r.rid] <= ttft_slo + _EPS]

    def goodput_qps(self, ttft_slo: "Optional[float]" = None) -> float:
        """Completed (SLO-meeting) requests per *second* of makespan."""
        if self.makespan <= 0:
            return 0.0
        return len(self.completed(ttft_slo)) / (self.makespan / self.freq_hz)

    @property
    def n_preemptions(self) -> int:
        return sum(r.preemptions for r in self.requests)

    @property
    def n_evictions(self) -> int:
        return sum(r.evictions for r in self.requests)

    def summary(self, ttft_slo: "Optional[float]" = None,
                ) -> "dict[str, float]":
        """One flat dict for benches/CLI tables."""
        s = self.ttft_stats()
        s.update(makespan=self.makespan,
                 completed=float(len(self.completed())),
                 goodput_qps=self.goodput_qps(ttft_slo),
                 epochs=float(len(self.epochs)),
                 preemptions=float(self.n_preemptions),
                 evictions=float(self.n_evictions))
        return s


class OnlineServingEngine:
    """The closed loop: arrivals in, committed admission epochs out.

    ``policy`` names any registered concrete policy, ``"auto"`` (classic
    slack-bounded sweep), or ``"auto-slo"`` — with ``ttft_p99_slo`` set
    (cycles), planning always goes through the SLO-aware sweep.  Plans
    are priced with ``plan_backend`` (the analytical closed form — cheap
    enough for every admission); committed epochs execute on
    ``execute_backend`` (``"desim"`` grounds spans in the DES;
    ``"analytical"`` keeps large saturation sweeps fast).

    ``max_inflight`` bounds the set re-planned each epoch (default:
    unbounded — every arrived request).  ``evict_to_admit=True`` lets a
    waiting arrival displace the least-progressed *decoding* request
    (state retained, re-admitted later) instead of queueing behind it.

    ``kv_hot_blocks`` (default ``None`` = unlimited KV) turns on the
    paged KV-cache residency model: a
    :class:`~repro_torch.serving.kvcache.PagedKVCache` of that many hot
    blocks is threaded across admission epochs — prefill/decode credit
    appends KV tokens, decode participation re-pins cold blocks
    (``ensure_resident``), and the per-request residency / refill bytes
    feed :class:`~repro_torch.serving.scheduler.PolicyContext` so
    residency-aware policies can prefer hot requests and the priced
    plans carry ``kv_refill`` memory nodes.  Evictions and refills emit
    ``kv_evicted`` / ``kv_refill`` span markers and
    ``online_kv_*`` counters.
    """

    def __init__(self, cfg, *, max_batch: int = 4,
                 max_new_tokens: int = 8, units: int = 1,
                 policy: str = "full-prefill", overlap: str = "chained",
                 plan_backend: str = "analytical",
                 execute_backend: str = "desim",
                 max_inflight: "Optional[int]" = None,
                 evict_to_admit: bool = False,
                 ttft_p99_slo: "Optional[float]" = None,
                 policy_kw: "Optional[dict]" = None,
                 freq_hz: "Optional[float]" = None,
                 kv_hot_blocks: "Optional[int]" = None,
                 kv_block_tokens: int = 16, kv_policy: str = "lru",
                 kv_seed: int = 0, kv_commit_steps: int = 2,
                 metrics=None, **backend_kwargs):
        from repro_torch.core.config import CASE_STUDY
        from repro_torch.serving.engine import ServingEngine
        if max_inflight is not None and max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, "
                             f"got {max_inflight}")
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_new_tokens = max_new_tokens
        self.units = units
        self.policy = policy
        self.overlap = overlap
        self.plan_backend = plan_backend
        self.execute_backend = execute_backend
        self.max_inflight = max_inflight
        self.evict_to_admit = evict_to_admit
        self.ttft_p99_slo = ttft_p99_slo
        self.policy_kw = dict(policy_kw or {})
        if kv_commit_steps < 1:
            raise ValueError(f"kv_commit_steps must be >= 1, "
                             f"got {kv_commit_steps}")
        self.kv_hot_blocks = kv_hot_blocks
        self.kv_block_tokens = kv_block_tokens
        self.kv_policy = kv_policy
        self.kv_seed = kv_seed
        self.kv_commit_steps = kv_commit_steps
        self.kv_cache = None           # built per run() when enabled
        self.backend_kwargs = dict(backend_kwargs)
        unit = backend_kwargs.get("unit")
        self.freq_hz = float(freq_hz if freq_hz is not None else
                             getattr(unit, "freq_hz", CASE_STUDY.freq_hz))
        # params are never touched on the modelling path; the inner
        # engine supplies run_schedule + metrics plumbing.
        self.inner = ServingEngine(cfg, None, max_batch=max_batch,
                                   metrics=metrics)
        self.metrics = self.inner.metrics

    # ----- planning --------------------------------------------------------
    def _planner(self):
        from repro_torch.serving.scheduler import get_policy
        if self.policy in ("auto", "auto-slo") or \
                self.ttft_p99_slo is not None:
            return get_policy(
                "auto-slo", ttft_p99_target=self.ttft_p99_slo,
                backend_name=self.plan_backend,
                policy_kw=(self.policy_kw or None))
        return get_policy(self.policy, **self.policy_kw)

    def _plan(self, planner, ctx):
        sched = planner.schedule(ctx)
        if not getattr(planner, "meta", False):
            sched.overlap = self.overlap
        return sched, getattr(planner, "last_report", None)

    def _context(self, inflight: "list[OnlineRequest]", clock: float):
        from repro_torch.serving.scheduler import PolicyContext
        arr = tuple(max(0.0, r.arrival - clock) for r in inflight)
        kv_res, kv_ref = (), ()
        if self.kv_cache is not None:
            kv_res = tuple(self.kv_cache.residency(r.rid)
                           for r in inflight)
            kv_ref = tuple(self.kv_cache.refill_bytes(r.rid)
                           for r in inflight)
        return PolicyContext(
            cfg=self.cfg,
            prompt_lengths=tuple(r.prompt_len for r in inflight),
            max_batch=self.max_batch,
            max_new_tokens=self.max_new_tokens,
            units=self.units,
            arrival_times=arr if any(arr) else (),
            prefill_progress=tuple(r.prefill_done for r in inflight),
            decode_done=tuple(r.decode_done for r in inflight),
            kv_residency=kv_res, kv_refill_bytes=kv_ref)

    # ----- the event loop --------------------------------------------------
    def run(self, source: "Iterable") -> OnlineResult:
        """Drive the closed loop over an arrival source (any iterable of
        :class:`~repro_torch.serving.arrivals.Arrival`) until every request
        completes; returns the :class:`OnlineResult`."""
        from repro_torch.obs import SpanAssembler
        from repro_torch.serving.scheduler import (price_steps,
                                             schedule_timeline)
        arrivals = list(source)
        reqs = [OnlineRequest(i, a.time, a.prompt_len)
                for i, a in enumerate(arrivals)]
        self.kv_cache = None
        if self.kv_hot_blocks is not None:
            from repro_torch.serving.kvcache import (PagedKVCache,
                                               kv_bytes_per_token)
            # one request's full stream must fit the hot pool (vLLM's
            # block-manager admission rule): an oversized request would
            # deadlock on its own pinned blocks instead of thrashing.
            need = max((r.prompt_len for r in reqs), default=0) \
                + self.max_new_tokens
            need_blocks = -(-need // self.kv_block_tokens)
            if need_blocks > self.kv_hot_blocks:
                raise ValueError(
                    f"kv_hot_blocks={self.kv_hot_blocks} cannot hold one "
                    f"request's working set ({need} tokens = "
                    f"{need_blocks} blocks of {self.kv_block_tokens}); "
                    f"raise kv_hot_blocks or kv_block_tokens")
            self.kv_cache = PagedKVCache(
                hot_blocks=self.kv_hot_blocks,
                block_tokens=self.kv_block_tokens,
                kv_bytes_per_token=kv_bytes_per_token(self.cfg),
                policy=self.kv_policy, seed=self.kv_seed)
        asm = SpanAssembler(self.cfg.n_layers)
        for r in reqs:
            asm.observe_arrival(r.rid, r.arrival)
        pending = deque(reqs)
        waiting: "list[OnlineRequest]" = []
        inflight: "list[OnlineRequest]" = []
        epochs: "list[EpochRecord]" = []
        planner = self._planner()
        m = self.metrics
        pol = self.policy
        clock = 0.0
        while pending or waiting or inflight:
            # --- arrivals due now join the waiting queue ------------------
            while pending and pending[0].arrival <= clock + _EPS:
                waiting.append(pending.popleft())
            if not waiting and not inflight:
                clock = pending[0].arrival          # idle: jump to next
                continue
            # --- admission (+ optional eviction to admit) -----------------
            cap = self.max_inflight or (len(waiting) + len(inflight))
            admitted, evicted = [], []
            while waiting and len(inflight) < cap:
                r = waiting.pop(0)
                if r.admitted is None:
                    r.admitted = clock
                elif r.evictions:
                    asm.mark(r.rid, "resumed", clock)
                inflight.append(r)
                admitted.append(r.rid)
            if self.evict_to_admit:
                while waiting:
                    victims = sorted(
                        (x for x in inflight
                         if x.decode_done > 0
                         and not x.done(self.max_new_tokens)),
                        key=lambda x: (x.decode_done, x.rid))
                    if not victims:
                        break
                    v = victims[0]
                    inflight.remove(v)
                    v.evictions += 1
                    evicted.append(v.rid)
                    asm.mark(v.rid, "evicted", clock)
                    waiting.append(v)           # back of the queue
                    r = waiting.pop(0)
                    if r.admitted is None:
                        r.admitted = clock
                    elif r.evictions:
                        asm.mark(r.rid, "resumed", clock)
                    inflight.append(r)
                    admitted.append(r.rid)
            inflight.sort(key=lambda x: x.rid)
            m.counter("online_admissions_total", policy=pol).inc(
                len(admitted))
            m.counter("online_evictions_total", policy=pol).inc(
                len(evicted))
            m.gauge("online_queue_depth", policy=pol).set(
                len(waiting) + len(pending))
            m.histogram("online_queue_depth_epochs", policy=pol).observe(
                len(waiting) + len(pending))
            # --- re-plan the in-flight set --------------------------------
            ctx = self._context(inflight, clock)
            sched, report = self._plan(planner, ctx)
            if not sched.steps:                    # nothing left to do
                for r in inflight:
                    if r.finish is None:
                        r.finish = clock
                inflight.clear()
                continue
            # --- commit horizon: steps starting before the next arrival ---
            cycles = price_steps(sched, self.plan_backend,
                                 **self.backend_kwargs)
            timeline = schedule_timeline(sched, cycles)
            if pending:
                horizon = pending[0].arrival - clock
                k = max(1, sum(1 for s, _ in timeline
                               if s < horizon - _EPS))
            else:
                k = len(sched.steps)
            if self.kv_cache is not None:
                # a plan is priced against residency at epoch start;
                # eviction churn invalidates it, so under a bounded KV
                # pool re-plan every ``kv_commit_steps`` steps.
                k = min(k, self.kv_commit_steps)
            csched = dataclasses.replace(
                sched, steps=sched.steps[:k], layers=sched.layers[:k],
                release_times=tuple(sched.release_times[:k]),
                refill_bytes=tuple(sched.refill_bytes[:k]))
            # --- execute the committed epoch on the grounded path ---------
            res = self.inner.run_schedule(
                csched, backend_name=self.execute_backend,
                workload=False, attach_spans=False,
                **self.backend_kwargs)
            spans = res.detail.get("step_spans")
            if spans is None:       # backend without per-step windows
                spans = {lt.name: w
                         for lt, w in zip(csched.layers, timeline[:k])}
            windows = [tuple(spans[lt.name]) for lt in csched.layers]
            epoch_make = max(e for _, e in windows)
            asm.add_epoch(csched, spans, offset=clock,
                          id_map={i: r.rid for i, r in
                                  enumerate(inflight)})
            # --- progress + finish bookkeeping ----------------------------
            self._advance(csched, windows, inflight, clock, asm=asm)
            cut = k < len(sched.steps)
            preempted = []
            if cut:
                for r in inflight:
                    if (0 < r.decode_done < self.max_new_tokens
                            and r.prefill_done >= r.prompt_len):
                        r.preemptions += 1
                        preempted.append(r.rid)
                        asm.mark(r.rid, "preempted", clock + epoch_make)
            done = [r for r in inflight if r.done(self.max_new_tokens)]
            inflight = [r for r in inflight
                        if not r.done(self.max_new_tokens)]
            if self.kv_cache is not None:
                for r in done:
                    self.kv_cache.release(r.rid, t=clock + epoch_make)
            m.counter("online_epochs_total", policy=pol).inc()
            m.counter("online_preemptions_total", policy=pol).inc(
                len(preempted))
            m.counter("online_completions_total", policy=pol).inc(
                len(done))
            chosen = (report or {}).get("chosen", {})
            epochs.append(EpochRecord(
                index=len(epochs), clock=clock, makespan=epoch_make,
                admitted=tuple(admitted), committed_steps=k,
                planned_steps=len(sched.steps), policy=sched.policy,
                strategy=sched.strategy, overlap=sched.overlap,
                preempted=tuple(preempted), evicted=tuple(evicted),
                candidate=chosen.get("candidate"),
                slo_met=chosen.get("slo_met")))
            clock += epoch_make
        log = asm.finalize()
        return OnlineResult(requests=reqs, epochs=epochs, span_log=log,
                            makespan=clock,
                            max_new_tokens=self.max_new_tokens,
                            freq_hz=self.freq_hz)

    def _advance(self, csched, windows, inflight, clock: float,
                 asm=None) -> None:
        """Fold one committed epoch's steps into per-request progress
        (padded-token prefill accounting, capped decode credit) and
        stamp finish times as requests drain.  When the paged KV cache
        is enabled, credited tokens append KV blocks and decode
        participation re-pins cold blocks, emitting ``kv_evicted`` /
        ``kv_refill`` markers into ``asm``."""
        n_layers = self.cfg.n_layers
        for step, (start, end) in zip(csched.steps, windows):
            dr = set(step.decode_requests or (
                step.requests if step.kind == "decode" else ()))
            pre = [i for i in step.requests if i not in dr]
            iters = max(1, round(step.repeat / n_layers))
            t = clock + end
            if pre:
                share = step.tokens - (len(dr) if step.kind == "mixed"
                                       else 0)
                per = max(1, math.ceil(share / len(pre)))
                for i in pre:
                    r = inflight[i]
                    credit = min(r.prompt_len, r.prefill_done + per) \
                        - r.prefill_done
                    r.prefill_done += credit
                    self._kv_append(r.rid, credit, t, asm)
            for i in dr:
                r = inflight[i]
                credit = min(self.max_new_tokens,
                             r.decode_done + iters) - r.decode_done
                r.decode_done += credit
                self._kv_touch(r.rid, t, asm)
                self._kv_append(r.rid, credit, t, asm)
            for i in step.requests:
                r = inflight[i]
                if r.done(self.max_new_tokens):
                    if r.finish is None and self.kv_cache is not None:
                        # free the pool at completion, not epoch end —
                        # a done request must never be an eviction
                        # victim (its span chain already closed).
                        self.kv_cache.release(r.rid, t=t)
                    r.finish = clock + end

    # ----- paged-KV bookkeeping -------------------------------------------
    def _kv_append(self, rid: int, n_tokens: int, t: float, asm) -> None:
        if self.kv_cache is None or n_tokens <= 0:
            return
        self._kv_evicted(self.kv_cache.append(rid, n_tokens, t=t), t, asm)

    def _kv_touch(self, rid: int, t: float, asm) -> None:
        """Decode needs the whole KV stream hot: re-pin cold blocks,
        pricing the refill into counters + span markers."""
        if self.kv_cache is None:
            return
        cost, evictions = self.kv_cache.ensure_resident(rid, t=t)
        if cost > 0.0:
            self.metrics.counter("online_kv_refills_total",
                                 policy=self.policy).inc()
            self.metrics.counter("online_kv_refill_bytes_total",
                                 policy=self.policy).inc(cost)
            if asm is not None:
                asm.mark(rid, "kv_refill", t)
        self._kv_evicted(evictions, t, asm)

    def _kv_evicted(self, evictions, t: float, asm) -> None:
        for victim, _slot, _tier in evictions:
            self.metrics.counter("online_kv_evictions_total",
                                 policy=self.policy).inc()
            if asm is not None:
                asm.mark(victim, "kv_evicted", t)


# ---------------------------------------------------------------------------
# Sustained-load benches: offered-QPS sweep + saturation knee.
# ---------------------------------------------------------------------------

def qps_sweep(cfg, qps_list: "Iterable[float]", *, n_requests: int = 8,
              seed: int = 0,
              prompt_lengths: "Optional[tuple[int, ...]]" = None,
              ttft_slo: "Optional[float]" = None,
              **engine_kw) -> "list[dict]":
    """Run the closed loop at each offered QPS (seeded Poisson traffic)
    and return one metrics row per point — the TTFT/ITL/goodput curves
    of one policy.  ``engine_kw`` goes to :class:`OnlineServingEngine`
    (``policy=``, ``units=``, ``execute_backend=``, ...)."""
    from repro_torch.serving.arrivals import PoissonArrivals, qps_to_gap
    rows = []
    for qps in qps_list:
        eng = OnlineServingEngine(cfg, **engine_kw)
        src = PoissonArrivals(
            mean_gap=qps_to_gap(qps, eng.freq_hz), n=n_requests,
            seed=seed, prompt_lengths=prompt_lengths)
        res = eng.run(src)
        row = {"offered_qps": float(qps), **res.summary(ttft_slo)}
        rows.append(row)
    return rows


def find_saturation(cfg, *, start_qps: float, factor: float = 2.0,
                    max_points: int = 7, keepup_ratio: float = 0.8,
                    n_requests: int = 8, seed: int = 0,
                    prompt_lengths: "Optional[tuple[int, ...]]" = None,
                    ttft_slo: "Optional[float]" = None,
                    **engine_kw) -> dict:
    """Locate a policy's goodput collapse: sweep offered QPS
    geometrically from ``start_qps`` until goodput falls below
    ``keepup_ratio`` × offered (or ``max_points`` is hit).  Returns the
    swept ``points``, the ``knee_qps`` (last offered rate the policy
    kept up with; 0.0 if it never did) and ``peak_goodput_qps`` — the
    saturation throughput the knee plateaus at."""
    points = qps_sweep(
        cfg, [start_qps * factor ** i for i in range(max_points)],
        n_requests=n_requests, seed=seed, prompt_lengths=prompt_lengths,
        ttft_slo=ttft_slo, **engine_kw)
    knee = 0.0
    saturated = False
    kept = []
    for row in points:
        row["keeps_up"] = (row["goodput_qps"]
                           >= keepup_ratio * row["offered_qps"])
        if row["keeps_up"] and not saturated:
            knee = row["offered_qps"]
        else:
            saturated = True
        kept.append(row)
    return {"points": kept, "knee_qps": knee,
            "peak_goodput_qps": max((r["goodput_qps"] for r in kept),
                                    default=0.0),
            "saturated": saturated}
