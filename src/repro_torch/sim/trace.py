"""Chrome-trace (Trace Event Format) export of DESim timelines.

The emitted JSON loads directly in Perfetto (https://ui.perfetto.dev)
or chrome://tracing: one *process* per matrix unit (plus pid 0 for
shared resources — the memory loader), one *thread* row per resource,
one complete ("X") event per busy interval, timestamps in microseconds
of simulated time.  Cluster results (``simulate_cluster``) name unit
resources ``u<i>/<resource>``; the exporter splits that prefix into the
process so each unit renders as its own track group instead of
interleaving on one row.  Overlapping events on the shared loader row
are the fair-share contention, made visible.

Serving-schedule graphs carry their batching policy's phase in the node
labels (``b0/prefill.c2/...``, ``dp3/decode/...``): the exporter
annotates each slice with ``args.phase`` (``prefill`` / ``prefill-chunk``
/ ``decode`` / ``mixed``) and a matching Perfetto colour, so a
``chunked-prefill`` or ``decode-priority`` timeline shows exactly where
decode iterations preempt prefill chunks.

Passing a priced serving schedule (the reference's ``BatchSchedule``;
duck-typed: ``steps`` with ``requests``, and ``layers``) as
``schedule=`` adds the request dimension: every serving slice gains
``args.request`` (the request ids riding that step) and ``args.step``,
and per request one chain of Perfetto *flow events* (``ph: "s"/"t"/"f"``
sharing ``id``) links its first slice of every step — so a request's
journey ``prefill chunk → decode iterations``, across whichever units
the partitioner placed them on, renders as a clickable arrow chain.
"""

from __future__ import annotations

import json
import re

from repro_torch.sim.desim import DESimResult

#: stable row order in the viewer, dispatcher (the cause) on top.
_RESOURCE_ORDER = ("dispatcher", "mem_loader", "scratchpad", "pe_array",
                   "vector_unit")

#: serving-policy phase of an event label; chunked prefill steps are
#: named ``.../prefill.c<j>/...`` by ``serving.scheduler``.
_PHASE_RE = re.compile(r"(?:^|/)(prefill|decode|mixed)(\.[^/]*)?(?:/|$)")

#: Perfetto reserved colour names per phase — decode pops against the
#: prefill stream at a glance.
_PHASE_COLOR = {"prefill": "thread_state_running",
                "prefill-chunk": "thread_state_runnable",
                "decode": "thread_state_iowait",
                "mixed": "thread_state_unknown"}


def phase_of(label: str) -> "str | None":
    """Serving-policy phase of a node/interval label, or ``None`` for
    non-schedule work (bare GEMM tiles, transfers): ``prefill`` /
    ``prefill-chunk`` (a chunked-prefill slice) / ``decode`` /
    ``mixed`` (decode iterations piggybacked on a prefill chunk)."""
    m = _PHASE_RE.search(label)
    if m is None:
        return None
    kind, suffix = m.group(1), m.group(2)
    if kind == "prefill" and suffix:
        return "prefill-chunk"
    return kind


def _split(resource: str) -> "tuple[int, str]":
    """``"u3/pe_array" -> (4, "pe_array")``; shared/unprefixed -> pid 0."""
    if resource.startswith("u") and "/" in resource:
        head, _, rest = resource.partition("/")
        if head[1:].isdigit():
            return int(head[1:]) + 1, rest
    return 0, resource


def _order(name: str) -> int:
    return _RESOURCE_ORDER.index(name) if name in _RESOURCE_ORDER \
        else len(_RESOURCE_ORDER)


def _step_of(label: str, step_names: "list[str]") -> "str | None":
    """Schedule-step name a node/interval label belongs to: the step
    whose name prefixes the label at a ``/`` boundary (node names are
    ``<step>/g<i>/t<r>,<c>`` plus DES suffixes), longest match wins."""
    best = None
    for name in step_names:
        if label == name or label.startswith(name + "/"):
            if best is None or len(name) > len(best):
                best = name
    return best


def _flow_events(schedule, slices: "dict[str, list[dict]]",
                 ) -> "list[dict]":
    """One flow-event chain per request id: bind to the request's first
    ``pe_array`` slice (first slice at all as fallback) of each of its
    steps, in schedule order — ``ph:"s"`` opens the chain, ``"t"`` steps
    it, ``"f"`` (``bp:"e"``) closes it, all sharing ``id``."""
    rep: "dict[str, dict]" = {}
    for name, evs in slices.items():
        pe = [e for e in evs if e["cat"].endswith("pe_array")]
        rep[name] = min(pe or evs, key=lambda e: e["ts"])
    flows: "list[dict]" = []
    for r in sorted({q for s in schedule.steps for q in s.requests}):
        chain = [rep[lt.name]
                 for s, lt in zip(schedule.steps, schedule.layers)
                 if r in s.requests and lt.name in rep]
        if len(chain) < 2:
            continue
        for i, ev in enumerate(chain):
            ph = "s" if i == 0 else ("f" if i == len(chain) - 1 else "t")
            flow = {"name": f"req{r}", "cat": "request", "ph": ph,
                    "id": r, "pid": ev["pid"], "tid": ev["tid"],
                    "ts": ev["ts"]}
            if ph == "f":
                flow["bp"] = "e"
            flows.append(flow)
    return flows


def chrome_trace(result: DESimResult, *, process_name: str = "cutev2-desim",
                 schedule=None) -> dict:
    """Trace Event Format dict: ``{"traceEvents": [...], ...}``.

    ``schedule`` (the priced ``BatchSchedule`` the graph was lowered
    from) annotates serving slices with their request ids and stitches
    per-request flow-event chains — see the module docstring."""
    us_per_cycle = 1e6 / result.freq_hz
    step_names: "list[str]" = []
    step_requests: "dict[str, list[int]]" = {}
    slices: "dict[str, list[dict]]" = {}
    if schedule is not None:
        step_names = [lt.name for lt in schedule.layers]
        step_requests = {lt.name: list(s.requests)
                         for s, lt in zip(schedule.steps, schedule.layers)}
    events = []
    rows = sorted(((_split(r), r) for r in result.intervals),
                  key=lambda x: (x[0][0], _order(x[0][1])))
    pids_seen = set()
    tids: "dict[int, int]" = {}
    for (pid, thread), rname in rows:
        if pid not in pids_seen:
            pids_seen.add(pid)
            pname = process_name if pid == 0 else \
                f"{process_name}/unit{pid - 1}"
            events.append({"name": "process_name", "ph": "M", "pid": pid,
                           "args": {"name": pname}})
        tid = tids.get(pid, 0)
        tids[pid] = tid + 1
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": thread}})
        for start, end, label in result.intervals[rname]:
            ev = {
                "name": label, "cat": rname, "ph": "X", "pid": pid,
                "tid": tid,
                "ts": start * us_per_cycle,
                "dur": max(end - start, 0.0) * us_per_cycle,
            }
            phase = phase_of(label)
            if phase is not None:
                ev["args"] = {"phase": phase}
                ev["cname"] = _PHASE_COLOR[phase]
            if step_names:
                step = _step_of(label, step_names)
                if step is not None:
                    ev.setdefault("args", {})
                    ev["args"]["step"] = step
                    ev["args"]["request"] = step_requests[step]
                    slices.setdefault(step, []).append(ev)
            events.append(ev)
    if schedule is not None and slices:
        events.extend(_flow_events(schedule, slices))
    other = {
        "total_cycles": result.cycles,
        "matrix_utilization": result.matrix_utilization,
        "resource_utilization": result.utilizations(),
    }
    n_units = getattr(result, "n_units", 1)
    if n_units > 1:
        other["n_units"] = n_units
        other["aggregate_matrix_utilization"] = \
            result.aggregate_matrix_utilization
        other["loader_utilization"] = result.loader_utilization
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": other,
    }


def dump_chrome_trace(result: DESimResult, path: str, **kw) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(result, **kw), f)
    return path
