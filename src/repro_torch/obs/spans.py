"""Per-request lifecycle spans over a priced :class:`BatchSchedule`.

A serving request's journey is ``arrival → admission →
prefill(.chunk_j) → decode_iter_k → complete``.  The schedule knows the
*structure* (which steps touch which request ids, how many decode
iterations each step carries); a priced timeline knows the *times*
(per-step ``(start, end)`` cycles — either the DES/closed-form
``detail["step_spans"]`` keyed by step label, or
``serving.scheduler.schedule_timeline``'s list).  :class:`SpanLog`
joins the two into one span list per request:

* ``arrival`` — a point span at the request's arrival cycle;
* ``admission`` — arrival to the start of the first step carrying the
  request (the queueing delay a batching policy controls);
* ``prefill`` / ``prefill.chunk<j>`` — the request's prefill steps, one
  span each (chunked policies produce one per chunk);
* ``decode_iter<k>`` — each decode iteration, sub-divided uniformly
  across its step's span exactly the way ``decode_latency_stats``
  places tokens (a step covering ``repeat / n_layers`` iterations
  emits them evenly);
* ``complete`` — a point span when the request's last step ends.

:meth:`SpanLog.validate` checks every request for a complete, monotonic
chain — the round-trip property the serving tests pin.  The same
request-id ↔ step mapping drives the Perfetto flow events
``sim.trace.chrome_trace(schedule=...)`` stitches across units.
"""

from __future__ import annotations

import dataclasses

#: start-ordering slack (cycles) — float noise, not real overlap.
_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class Span:
    """One lifecycle interval of one request, in simulated cycles."""

    request: int
    phase: str            # arrival | admission | prefill[.chunk<j>]
    #                     # | decode_iter<k> | complete
    start: float
    end: float
    step: int = -1        # schedule step index (-1: synthetic span)
    label: str = ""       # step layer name ("" : synthetic span)
    kind: str = ""        # step kind ("" : synthetic span)

    def to_json(self) -> dict:
        d = {"request": self.request, "phase": self.phase,
             "start": self.start, "end": self.end}
        if self.step >= 0:
            d.update(step=self.step, label=self.label, kind=self.kind)
        return d


def _decode_requests(step) -> "tuple[int, ...]":
    """Requests receiving a decode token from ``step`` — the same
    fallback ``decode_latency_stats`` applies (classic full-prefill pure
    decode steps leave ``decode_requests`` empty but mean everyone)."""
    return step.decode_requests or (
        step.requests if step.kind == "decode" else ())


def _step_windows(sched, step_spans) -> "list[tuple[float, float]]":
    """Normalise either timeline currency into per-step ``(start, end)``:
    a dict keyed by step label (``detail["step_spans"]``) or a list
    aligned with ``sched.steps`` (``schedule_timeline``)."""
    if isinstance(step_spans, dict):
        missing = [lt.name for lt in sched.layers
                   if lt.name not in step_spans]
        if missing:
            raise KeyError(f"step_spans missing steps {missing[:4]} "
                           f"(of {len(sched.steps)})")
        return [tuple(step_spans[lt.name]) for lt in sched.layers]
    spans = list(step_spans)
    if len(spans) != len(sched.steps):
        raise ValueError(f"{len(spans)} step spans for "
                         f"{len(sched.steps)} steps")
    return [tuple(s) for s in spans]


class SpanLog:
    """The lifecycle spans of every request of one priced schedule."""

    def __init__(self, spans: "list[Span]", n_requests: int = 0):
        self.spans = list(spans)
        self.n_requests = n_requests or (
            1 + max((s.request for s in self.spans), default=-1))

    # ----- construction ----------------------------------------------------
    @classmethod
    def from_schedule(cls, sched, step_spans, n_layers: int) -> "SpanLog":
        """Join a :class:`~repro_torch.serving.engine.BatchSchedule` with its
        priced per-step windows (dict by label or list by index) into
        per-request lifecycle spans.  ``n_layers`` converts a decode
        step's ``repeat`` into its iteration count, matching
        ``decode_latency_stats``."""
        windows = _step_windows(sched, step_spans)
        requests = sorted({r for s in sched.steps for r in s.requests})
        prefill_count = {r: sum(
            1 for s in sched.steps
            if r in s.requests and r not in _decode_requests(s))
            for r in requests}
        spans: "list[Span]" = []
        chunk_idx = {r: 0 for r in requests}
        decode_idx = {r: 0 for r in requests}
        first_start: "dict[int, float]" = {}
        last_end: "dict[int, float]" = {}
        for j, (step, lt, (start, end)) in enumerate(
                zip(sched.steps, sched.layers, windows)):
            dr = set(_decode_requests(step))
            iters = max(1, round(step.repeat / n_layers))
            for r in step.requests:
                first_start.setdefault(r, start)
                last_end[r] = max(last_end.get(r, end), end)
                if r in dr:
                    for k in range(iters):
                        s = start + (end - start) * k / iters
                        e = start + (end - start) * (k + 1) / iters
                        spans.append(Span(
                            r, f"decode_iter{decode_idx[r]}", s, e,
                            step=j, label=lt.name, kind=step.kind))
                        decode_idx[r] += 1
                else:
                    phase = ("prefill" if prefill_count[r] <= 1
                             else f"prefill.chunk{chunk_idx[r]}")
                    chunk_idx[r] += 1
                    spans.append(Span(r, phase, start, end, step=j,
                                      label=lt.name, kind=step.kind))
        for r in requests:
            arr = sched.arrival_of(r)
            spans.append(Span(r, "arrival", arr, arr))
            spans.append(Span(r, "admission", arr, first_start[r]))
            spans.append(Span(r, "complete", last_end[r], last_end[r]))
        spans.sort(key=lambda s: (s.request, s.start, s.end, s.step))
        return cls(spans, n_requests=len(requests))

    @classmethod
    def from_timeline(cls, sched, step_cycles: "list[float]",
                      n_layers: int) -> "SpanLog":
        """Build from per-step prices via the first-order
        ``schedule_timeline`` placement (no DES run needed)."""
        from repro_torch.serving.scheduler import schedule_timeline
        return cls.from_schedule(sched, schedule_timeline(sched, step_cycles),
                                 n_layers)

    # ----- queries ---------------------------------------------------------
    def requests(self) -> "tuple[int, ...]":
        return tuple(sorted({s.request for s in self.spans}))

    def for_request(self, request: int) -> "list[Span]":
        return [s for s in self.spans if s.request == request]

    def phase(self, request: int, phase: str) -> Span:
        for s in self.for_request(request):
            if s.phase == phase:
                return s
        raise KeyError(f"request {request} has no {phase!r} span")

    def ttft(self, request: int) -> float:
        """Arrival to end of the first decode iteration — the span-log
        view of the TTFT ``decode_latency_stats`` reports."""
        return (self.phase(request, "decode_iter0").end
                - self.phase(request, "arrival").start)

    def to_json(self) -> "list[dict]":
        return [s.to_json() for s in self.spans]

    # ----- the round-trip property -----------------------------------------
    def validate(self) -> "list[str]":
        """Every request must carry a *complete, monotonic* chain:
        arrival and admission first, at least one work span, complete
        last, successive spans never starting before their predecessor
        (within float slack) and every span non-negative.  Returns the
        list of violations (empty == healthy)."""
        errors: "list[str]" = []
        for r in self.requests():
            chain = self.for_request(r)
            phases = [s.phase for s in chain]
            for needed in ("arrival", "admission", "complete"):
                if needed not in phases:
                    errors.append(f"request {r}: missing {needed!r} span")
            if not any(p.startswith(("prefill", "decode")) for p in phases):
                errors.append(f"request {r}: no prefill/decode work span")
            if phases and phases[-1] != "complete":
                errors.append(f"request {r}: chain ends with "
                              f"{phases[-1]!r}, not 'complete'")
            prev = None
            for s in chain:
                if s.end < s.start - _EPS:
                    errors.append(f"request {r}: span {s.phase} ends "
                                  f"before it starts ({s.end} < {s.start})")
                if prev is not None and s.start < prev.start - _EPS:
                    errors.append(
                        f"request {r}: span {s.phase} starts at {s.start} "
                        f"before {prev.phase} at {prev.start}")
                prev = s
        return errors

    def complete(self) -> bool:
        """True when every request's chain validates clean."""
        return not self.validate()

    def __len__(self) -> int:
        return len(self.spans)

    def __iter__(self):
        return iter(self.spans)

    def __repr__(self) -> str:
        return (f"SpanLog({len(self.spans)} spans, "
                f"{self.n_requests} requests)")


class SpanAssembler:
    """Builds one global :class:`SpanLog` across *admission epochs*.

    The online loop (:mod:`repro_torch.serving.online`) executes one committed
    sub-schedule per epoch; each epoch's DES/closed-form
    ``detail["step_spans"]`` is epoch-relative and keyed by *local*
    request ids.  The assembler joins them into the same per-request
    lifecycle chain :meth:`SpanLog.from_schedule` produces offline:
    per-epoch work spans are shifted onto the global clock (``offset``)
    and remapped to global ids (``id_map``), decode-iteration and
    prefill-chunk counters persist across epochs (a preempted stream
    resumed three epochs later continues at ``decode_iter<k>``, not
    ``decode_iter0``), and :meth:`finalize` closes every chain with the
    synthetic ``arrival`` / ``admission`` / ``complete`` spans — so
    :meth:`SpanLog.validate` holds across preemption and eviction
    (pinned by ``tests/test_online.py``).

    Point *marker* spans (:meth:`mark` — ``preempted`` / ``evicted`` /
    ``resumed``) ride in the same chain; ``validate`` ignores unknown
    phases as long as the chain stays monotonic.
    """

    def __init__(self, n_layers: int):
        self.n_layers = n_layers
        self._decode_idx: "dict[int, int]" = {}
        self._decode_spans: "list[Span]" = []
        # prefill work per request, phase assigned at finalize (one
        # chunk -> "prefill", several -> "prefill.chunk<j>" in order —
        # the offline labels exactly).
        self._prefill: "dict[int, list[tuple]]" = {}
        self._marks: "list[Span]" = []
        self._arrival: "dict[int, float]" = {}
        self._first_start: "dict[int, float]" = {}
        self._last_end: "dict[int, float]" = {}
        self._step_base = 0

    def observe_arrival(self, request: int, time: float) -> None:
        """Record a request's (global) arrival cycle."""
        self._arrival[request] = float(time)

    def mark(self, request: int, phase: str, time: float) -> None:
        """Append a point marker span (``preempted`` / ``evicted`` /
        ``resumed``) to a request's chain at a global cycle."""
        self._marks.append(Span(request, phase, float(time), float(time)))

    def add_epoch(self, sched, step_spans, *, offset: float = 0.0,
                  id_map: "Optional[dict[int, int]]" = None) -> None:
        """Fold one committed epoch's priced windows into the log.

        ``sched`` / ``step_spans`` use the epoch's *local* request ids
        and epoch-relative cycles; ``id_map`` translates local → global
        ids (identity when omitted) and ``offset`` is the epoch's start
        on the global clock."""
        windows = _step_windows(sched, step_spans)
        for j, (step, lt, (s0, e0)) in enumerate(
                zip(sched.steps, sched.layers, windows)):
            start, end = s0 + offset, e0 + offset
            dr = set(_decode_requests(step))
            iters = max(1, round(step.repeat / self.n_layers))
            gj = self._step_base + j
            for r in step.requests:
                g = id_map[r] if id_map is not None else r
                self._first_start.setdefault(g, start)
                self._last_end[g] = max(self._last_end.get(g, end), end)
                if r in dr:
                    k0 = self._decode_idx.get(g, 0)
                    for k in range(iters):
                        s = start + (end - start) * k / iters
                        e = start + (end - start) * (k + 1) / iters
                        self._decode_spans.append(Span(
                            g, f"decode_iter{k0 + k}", s, e,
                            step=gj, label=lt.name, kind=step.kind))
                    self._decode_idx[g] = k0 + iters
                else:
                    self._prefill.setdefault(g, []).append(
                        (start, end, gj, lt.name, step.kind))
        self._step_base += len(sched.steps)

    def finalize(self) -> SpanLog:
        """Close every chain and return the global :class:`SpanLog`."""
        spans: "list[Span]" = list(self._decode_spans)
        for g, chunks in self._prefill.items():
            one = len(chunks) == 1
            for j, (s, e, gj, label, kind) in enumerate(chunks):
                phase = "prefill" if one else f"prefill.chunk{j}"
                spans.append(Span(g, phase, s, e, step=gj,
                                  label=label, kind=kind))
        spans.extend(self._marks)
        requests = sorted(self._first_start)
        for g in requests:
            arr = self._arrival.get(g, 0.0)
            spans.append(Span(g, "arrival", arr, arr))
            spans.append(Span(g, "admission", arr, self._first_start[g]))
            spans.append(Span(g, "complete", self._last_end[g],
                              self._last_end[g]))
        spans.sort(key=lambda s: (s.request, s.start, s.end, s.step))
        return SpanLog(spans, n_requests=len(requests))
