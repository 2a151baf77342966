"""The port's metrics registry and ``instrument`` against the reference's.

The same sequence of counter, gauge and histogram calls goes into a
reference and a port ``MetricsRegistry``; their JSON snapshots and
Prometheus texts must be equal.  ``instrument`` counts ``run_graph``
calls per backend into the default registry when it is enabled, and is
a plain call when it is disabled.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs import metrics as j_metrics                    # noqa: E402
from repro_torch import backend                               # noqa: E402
from repro_torch import obs                                   # noqa: E402
from repro_torch.core.task import MatMulTask                  # noqa: E402
from repro_torch.obs import metrics                           # noqa: E402


def _feed(reg, seed):
    """A seeded sequence of metric calls, the same in either package."""
    rng = np.random.default_rng(seed)
    for i in range(40):
        op = int(rng.integers(0, 5))
        label = {"backend": ["kernel", "torch", "desim"][i % 3],
                 "section": "run_graph"}
        if op == 0:
            reg.counter("calls_total", **label).inc(float(rng.integers(1, 4)))
        elif op == 1:
            reg.gauge("utilization", unit=str(i % 2)).set(rng.random())
        elif op == 2:
            reg.gauge("in_flight").inc(float(rng.integers(0, 3)))
            reg.gauge("in_flight").dec(0.5)
        else:
            reg.histogram("seconds", **label).observe(rng.random() * 1e-3)
    reg.counter("unlabelled_total").inc()
    with reg.timer("timed", phase="x"):
        pass
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_snapshot_and_prometheus_equal_reference(seed):
    ref = _feed(j_metrics.MetricsRegistry(), seed)
    port = _feed(metrics.MetricsRegistry(), seed)
    # the timer observes wall-clock time: the same series, not the value
    for reg in (ref, port):
        reg._metrics = {k: v for k, v in reg._metrics.items()
                        if k[1] != "timed"}
    assert (json.dumps(port.snapshot(), sort_keys=True)
            == json.dumps(ref.snapshot(), sort_keys=True))
    assert port.prometheus_text() == ref.prometheus_text()


@pytest.mark.parametrize("q", [0.0, 10.0, 50.0, 90.0, 99.0, 100.0])
def test_percentile_equals_reference(q):
    xs = list(np.random.default_rng(3).random(37))
    assert metrics._percentile(xs, q) == j_metrics._percentile(xs, q)
    assert metrics._percentile([], q) == 0.0


def test_registry_rules():
    reg = metrics.MetricsRegistry()
    with pytest.raises(ValueError):
        reg.counter("c").inc(-1.0)
    reg.counter("x")
    with pytest.raises(ValueError):
        reg.gauge("x")
    assert reg.counter("c", a=1) is reg.counter("c", a="1")
    off = metrics.MetricsRegistry(enabled=False)
    assert off.counter("c") is metrics.NULL_METRIC
    off.histogram("h").observe(1.0)
    assert off.snapshot() == {"counters": {}, "gauges": {},
                              "histograms": {}}
    assert off.prometheus_text() == ""


def _graph_calls(names, calls):
    a = torch.ones((8, 16), dtype=torch.int8)
    b = torch.ones((16, 8), dtype=torch.int8)
    for name in names:
        eng = backend.get(name)
        graph = eng.lower(MatMulTask(m=8, n=8, k=16))
        for _ in range(calls):
            eng.run_graph(graph, backend.MatMulOperands(a, b))


def test_instrument_counts_run_graph_per_backend():
    reg = obs.default_registry()
    assert not reg.enabled
    reg.clear()
    obs.enable_metrics()
    try:
        _graph_calls(("kernel", "torch", "desim"), 2)
        _graph_calls(("kernel",), 1)
        snap = reg.snapshot()
    finally:
        obs.disable_metrics()
        reg.clear()
    calls = {row["labels"]["backend"]: row["value"]
             for row in snap["counters"]["backend_calls_total"]}
    assert calls == {"kernel": 3.0, "torch": 2.0, "desim": 2.0}
    seconds = {row["labels"]["backend"]: row["count"]
               for row in snap["histograms"]["backend_seconds"]}
    assert seconds == calls
    assert all(row["labels"]["section"] == "run_graph"
               for row in snap["histograms"]["backend_seconds"])


def test_instrument_is_a_plain_call_when_disabled():
    reg = obs.default_registry()
    reg.clear()
    assert not reg.enabled
    _graph_calls(("kernel", "desim"), 1)
    assert reg.snapshot() == {"counters": {}, "gauges": {},
                              "histograms": {}}

    class Probe:
        name = "probe"

        @obs.instrument("run_graph")
        def run(self, x):
            return x + 1
    assert Probe().run(1) == 2
    assert Probe.run.__name__ == "run"
