"""Metrics registry: counters, gauges and histograms with labels.

The paper's headline results are *measurement claims* (≥90% matrix-unit
utilization, >30% of the end-to-end gain from matrix–vector overlap);
this module is the repo's durable measurement layer.  A
:class:`MetricsRegistry` holds three metric kinds, each addressable by
name + label set:

* :class:`Counter` — monotonically increasing totals (requests planned,
  cache hits, graphs priced);
* :class:`Gauge` — last-write-wins values (aggregate utilization of the
  most recent run);
* :class:`Histogram` — sampled distributions with nearest-rank
  ``p50/p90/p99`` (TTFT, inter-token latency, per-step cycles,
  backend wall-clock).

Two exporters: :meth:`MetricsRegistry.snapshot` (a JSON-able dict) and
:meth:`MetricsRegistry.prometheus_text` (the Prometheus text exposition
format, so a scraper can lift the same numbers).

Collection is **disabled by default**: the module-level default
registry starts disabled, and a disabled registry hands out a shared
no-op metric so instrumented hot paths (the DES, backend ``run_graph``)
pay one attribute check and nothing else.  Entry points that measure
(``chip_smoke.py``'s ``exec`` phase) enable it; tests construct their
own enabled registries.  A copy of the reference's
``repro/obs/metrics.py``.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional


def _percentile(xs: "list[float]", q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); 0.0 on empty input —
    the same convention ``serving.scheduler`` uses."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[min(rank, len(xs)) - 1]


@dataclasses.dataclass
class Counter:
    """Monotonic total.  ``inc`` with a negative amount raises — a
    counter that can go down is a gauge wearing a disguise."""

    name: str
    labels: "tuple[tuple[str, str], ...]" = ()
    value: float = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease "
                             f"(inc({amount}))")
        self.value += amount


@dataclasses.dataclass
class Gauge:
    """Last-write-wins value."""

    name: str
    labels: "tuple[tuple[str, str], ...]" = ()
    value: float = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount


@dataclasses.dataclass
class Histogram:
    """Sampled distribution; keeps the raw samples (serving runs are
    thousands of observations, not millions) so any percentile is exact
    nearest-rank rather than bucket-interpolated."""

    name: str
    labels: "tuple[tuple[str, str], ...]" = ()
    samples: "list[float]" = dataclasses.field(default_factory=list)

    def observe(self, value: float) -> None:
        self.samples.append(float(value))

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def sum(self) -> float:
        return float(sum(self.samples))

    def percentile(self, q: float) -> float:
        return _percentile(self.samples, q)

    def summary(self) -> "dict[str, float]":
        return {
            "count": float(self.count),
            "sum": self.sum,
            "min": min(self.samples) if self.samples else 0.0,
            "max": max(self.samples) if self.samples else 0.0,
            "p50": self.percentile(50.0),
            "p90": self.percentile(90.0),
            "p99": self.percentile(99.0),
        }


class _NullMetric:
    """The shared no-op metric a disabled registry hands out: every
    mutator is a pass, so instrumented call sites need no branches."""

    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        pass

    def dec(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass


NULL_METRIC = _NullMetric()


def _label_key(labels: dict) -> "tuple[tuple[str, str], ...]":
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Named, labeled metrics behind get-or-create accessors.

    ``counter("requests_total", policy="auto")`` returns the one child
    for that (name, label set) — repeated calls accumulate into the same
    series.  A disabled registry returns :data:`NULL_METRIC` from every
    accessor, making instrumentation free when observability is off.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._metrics: "dict[tuple, object]" = {}
        self._kinds: "dict[str, str]" = {}     # name -> kind (consistency)

    # ----- lifecycle -------------------------------------------------------
    def enable(self) -> "MetricsRegistry":
        self.enabled = True
        return self

    def disable(self) -> "MetricsRegistry":
        self.enabled = False
        return self

    def clear(self) -> None:
        self._metrics.clear()
        self._kinds.clear()

    # ----- accessors -------------------------------------------------------
    def _get(self, kind: str, cls, name: str, labels: dict):
        if not self.enabled:
            return NULL_METRIC
        prev = self._kinds.setdefault(name, kind)
        if prev != kind:
            raise ValueError(f"metric {name!r} already registered as a "
                             f"{prev}, not a {kind}")
        key = (kind, name, _label_key(labels))
        metric = self._metrics.get(key)
        if metric is None:
            metric = self._metrics[key] = cls(name, key[2])
        return metric

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", Histogram, name, labels)

    def timer(self, name: str, **labels) -> "_Timer":
        """Context manager observing elapsed wall-clock seconds into the
        ``name`` histogram (no-op when disabled)."""
        return _Timer(self.histogram(name, **labels))

    # ----- exporters -------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able dump: ``{counters: {name: [{labels, value}]},
        gauges: {...}, histograms: {name: [{labels, count, sum, p50,
        p90, p99, ...}]}}`` — the shape ``--metrics-out`` writes and the
        docs catalogue documents."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for (kind, name, labels), m in sorted(self._metrics.items()):
            row = {"labels": dict(labels)}
            if kind == "histogram":
                row.update(m.summary())
                out["histograms"].setdefault(name, []).append(row)
            else:
                row["value"] = m.value
                out[kind + "s"].setdefault(name, []).append(row)
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (one line per series;
        histograms exported as ``_count`` / ``_sum`` plus quantile
        gauges — a pragmatic summary, not cumulative buckets)."""
        lines: "list[str]" = []

        def fmt(name, labels, value):
            if labels:
                body = ",".join(f'{k}="{v}"' for k, v in labels)
                return f"{name}{{{body}}} {value:g}"
            return f"{name} {value:g}"

        by_name: "dict[tuple, list]" = {}
        for (kind, name, labels), m in sorted(self._metrics.items()):
            by_name.setdefault((kind, name), []).append((labels, m))
        for (kind, name), series in by_name.items():
            ptype = {"counter": "counter", "gauge": "gauge",
                     "histogram": "summary"}[kind]
            lines.append(f"# TYPE {name} {ptype}")
            for labels, m in series:
                if kind == "histogram":
                    lines.append(fmt(name + "_count", labels, m.count))
                    lines.append(fmt(name + "_sum", labels, m.sum))
                    for q in (50, 90, 99):
                        ql = labels + (("quantile", f"0.{q}"),)
                        lines.append(fmt(name, ql, m.percentile(q)))
                else:
                    lines.append(fmt(name, labels, m.value))
        return "\n".join(lines) + ("\n" if lines else "")


class _Timer:
    def __init__(self, hist):
        self._hist = hist
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.observe(time.perf_counter() - self._t0)
        return False


#: The process-wide default registry.  Starts **disabled** — the DES and
#: backend hot paths are instrumented against it, and outside the entry
#: points that measure every observation is a no-op.
_DEFAULT = MetricsRegistry(enabled=False)


def default_registry() -> MetricsRegistry:
    return _DEFAULT


def enable_metrics() -> MetricsRegistry:
    """Turn the default registry on (entry points that measure)."""
    return _DEFAULT.enable()


def disable_metrics() -> MetricsRegistry:
    return _DEFAULT.disable()
