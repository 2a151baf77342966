"""The port's serving launcher in its planning and online modes against
the reference launcher (``repro.launch.serve``), at ``--reduced`` with
``--device cpu``: every ``[plan:…]`` / ``[online:…]`` line and summary
table equal, wall-clock seconds aside, and the metrics snapshot's
deterministic parts equal.  The reference's weights and serving run are
stubbed out (its plan and online lines need neither); the port's
launcher serves its requests on the CPU after planning.  A planning-only
``ServingEngine(cfg, None)`` cannot ``run``; with ``tuned=True`` it plans
and prices as the reference's does.
"""

import contextlib
import io
import json
import re
from unittest import mock

import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.launch import serve as j_serve                 # noqa: E402
from repro.obs import disable_metrics as j_disable        # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs.registry import get_config      # noqa: E402
from repro_torch.launch import serve                      # noqa: E402
from repro_torch.obs import disable_metrics               # noqa: E402
from repro_torch.serving.arrivals import (PoissonArrivals,  # noqa: E402
                                          write_trace)
from repro_torch.serving.engine import ServingEngine     # noqa: E402


class _NoWeights:
    @staticmethod
    def init(cfg, key):
        return None


def _text(raw):
    keep = [ln for ln in raw.splitlines()
            if not re.match(r"served |  req\d+: |metrics snapshot -> ", ln)]
    return re.sub(r" in [0-9.]+s wall", " in _s wall", "\n".join(keep))


def _reference(argv):
    buf = io.StringIO()
    with mock.patch.object(j_serve, "family_module",
                           lambda cfg: _NoWeights), \
            mock.patch.object(JEngine, "run", lambda self, **kw: []), \
            contextlib.redirect_stdout(buf):
        j_serve.main(argv)
    return buf.getvalue()


def _port(argv, capsys):
    serve.main(argv + ["--device", "cpu"])
    return capsys.readouterr().out


@pytest.fixture(autouse=True)
def _metrics_off():
    yield
    disable_metrics()
    j_disable()


PLAN_ARGS = {
    "desim": ["--plan", "desim"],
    "analytical": ["--plan", "analytical"],
    "cluster": ["--plan", "desim-cluster", "--plan-units", "4"],
    "cluster-row-panel": ["--plan", "desim-cluster", "--plan-units", "2",
                          "--plan-strategy", "row-panel"],
    "auto": ["--plan", "analytical", "--policy", "auto",
             "--arrival-gap", "5000"],
    "relaxed-panel": ["--plan", "desim", "--policy", "chunked-prefill",
                      "--overlap", "relaxed", "--plan-granularity", "panel"],
}


@pytest.mark.parametrize("name", list(PLAN_ARGS))
def test_plan_lines_equal_the_reference(name, capsys):
    argv = ["--reduced", "--requests", "5", "--max-new", "4"] \
        + PLAN_ARGS[name]
    ref = _text(_reference(argv))
    capsys.readouterr()
    out = _port(argv, capsys)
    assert _text(out) == ref
    assert ref.startswith(f"[plan:{PLAN_ARGS[name][1]}]")
    assert "served 5 requests, 20 tokens on cpu" in out


ONLINE_ARGS = {
    "qps": ["--qps", "2000"],
    "qps-decode-priority": ["--qps", "20000", "--policy",
                            "decode-priority", "--plan", "analytical"],
    "qps-slo": ["--qps", "5000", "--slo-ttft-p99-ms", "0.01"],
    "qps-cluster": ["--qps", "4000", "--plan", "desim-cluster",
                    "--plan-units", "2"],
}


@pytest.mark.parametrize("name", list(ONLINE_ARGS))
def test_online_lines_equal_the_reference(name, capsys):
    argv = ["--reduced", "--requests", "6", "--max-new", "6"] \
        + ONLINE_ARGS[name]
    ref = _text(_reference(argv))
    capsys.readouterr()
    out = _port(argv, capsys)
    assert _text(out) == ref
    assert ref.startswith("[online:") and "served" not in out


def test_arrival_trace_lines_equal_the_reference(tmp_path, capsys):
    path = tmp_path / "arrivals.jsonl"
    write_trace(str(path), PoissonArrivals(mean_gap=1500.0, n=7, seed=4,
                                           prompt_lengths=(5, 11, 3)))
    argv = ["--reduced", "--max-new", "5", "--arrival-trace", str(path)]
    ref = _text(_reference(argv))
    capsys.readouterr()
    assert _text(_port(argv, capsys)) == ref
    assert "offered=trace" in ref


def _deterministic(snapshot):
    """The snapshot without wall-clock histograms (backend_seconds)."""
    return {kind: {name: rows for name, rows in group.items()
                   if name != "backend_seconds"}
            for kind, group in snapshot.items() if isinstance(group, dict)}


@pytest.mark.parametrize("argv", [
    ["--plan", "desim", "--requests", "4", "--max-new", "3"],
    ["--qps", "3000", "--requests", "4", "--max-new", "3"]],
    ids=("plan", "online"))
def test_metrics_out_equal_the_reference(argv, tmp_path, capsys):
    ours, ref = tmp_path / "port.json", tmp_path / "ref.json"
    _reference(["--reduced", *argv, "--metrics-out", str(ref)])
    capsys.readouterr()
    out = _port(["--reduced", *argv, "--metrics-out", str(ours)], capsys)
    assert f"metrics snapshot -> {ours}" in out
    mine, theirs = (json.loads(p.read_text()) for p in (ours, ref))
    assert _deterministic(mine) == _deterministic(theirs)
    assert mine["counters"]["serving_plans_total"] or "--qps" in argv


def test_prometheus_text_out(tmp_path, capsys):
    path = tmp_path / "metrics.prom"
    _port(["--reduced", "--plan", "analytical", "--requests", "3",
           "--max-new", "2", "--metrics-out", str(path)], capsys)
    assert "serving_plans_total" in path.read_text()


def test_refusals(capsys):
    with mock.patch.object(torch.cuda, "is_available", lambda: False):
        for argv in (["--reduced"], ["--reduced", "--qps", "100"],
                     ["--reduced", "--plan", "desim"]):
            with pytest.raises(SystemExit, match="no CUDA device"):
                serve.main(argv)
    with pytest.raises(SystemExit):          # executes, models no time
        serve.main(["--reduced", "--device", "cpu", "--plan", "torch"])
    assert "--plan" in capsys.readouterr().err


def test_tuned_and_planning_only_run_raise():
    """``tuned=True`` plans and prices now (``tune/*`` is ported), equal
    to the reference's; a planning-only engine still cannot ``run``."""
    te = ServingEngine(get_config("yi-6b", reduced=True), None,
                       max_batch=2)
    je = JEngine(j_get_config("yi-6b", reduced=True), None, max_batch=2)
    for n in (5, 9, 3):
        te.submit(torch.zeros(n, dtype=torch.int32))
        je.submit(jnp.zeros(n, jnp.int32))
    assert repr(te.plan(4, units=2, tuned=True)) == \
        repr(je.plan(4, units=2, tuned=True))
    _, tres = te.evaluate_schedule("desim", max_new_tokens=4, tuned=True)
    _, jres = je.evaluate_schedule("desim", max_new_tokens=4, tuned=True)
    assert tres.cycles == jres.cycles
    with pytest.raises(RuntimeError, match="params=None"):
        te.run(max_new_tokens=2)
    assert te.device == torch.device("cpu")
    assert all(not r.tokens.is_cuda for r in te.requests)
