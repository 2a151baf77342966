"""Observability: metrics registry, lifecycle spans, instrumentation.

* :mod:`repro_torch.obs.metrics` — counters / gauges / histograms with
  ``p50/p90/p99``, JSON-snapshot and Prometheus-text exporters, behind
  a **disabled-by-default** process registry (a copy of the reference's
  ``repro/obs/metrics.py``);
* :mod:`repro_torch.obs.spans` — per-request lifecycle :class:`SpanLog`
  (``arrival → admission → prefill(.chunk_j) → decode_iter_k →
  complete``) joined from a :class:`BatchSchedule` and a priced
  timeline (a copy of the reference's ``repro/obs/spans.py``);
* :func:`instrument` — the shared decorator the backend wrappers put on
  ``run_graph`` / ``run_workload``: wall-clock timings into the default
  registry, one attribute check and a plain call when it is disabled.
"""

from __future__ import annotations

import functools
import time

from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, NULL_METRIC,
                                     default_registry, disable_metrics,
                                     enable_metrics)
from repro_torch.obs.spans import Span, SpanAssembler, SpanLog

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NULL_METRIC",
    "Span", "SpanAssembler", "SpanLog", "default_registry",
    "disable_metrics", "enable_metrics", "instrument",
]


def instrument(section: str, label_attr: str = "name"):
    """Decorate a backend method with wall-clock timing metrics.

    When the default registry is enabled, each call observes its elapsed
    seconds into the ``backend_seconds`` histogram and bumps the
    ``backend_calls_total`` counter, both labeled
    ``{backend: getattr(self, label_attr), section: section}``.  When it
    is disabled — the default — the wrapper is a single truthiness check
    and a plain call, keeping the DES hot path unburdened.
    """
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            reg = default_registry()
            if not reg.enabled:
                return fn(self, *args, **kwargs)
            backend = getattr(self, label_attr, type(self).__name__)
            t0 = time.perf_counter()
            try:
                return fn(self, *args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                reg.histogram("backend_seconds", backend=backend,
                              section=section).observe(dt)
                reg.counter("backend_calls_total", backend=backend,
                            section=section).inc()
        return wrapper
    return deco
