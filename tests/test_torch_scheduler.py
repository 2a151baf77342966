"""The port's serving planner (``repro_torch.serving.scheduler``, the
engine's planning half, the analytical and cluster backends) against the
reference's, on the same queues: ``==`` throughout.

* every batching policy's steps and layers, under arrivals, carried
  progress, KV residency and a cluster width;
* ``price_steps``, ``decode_latency_stats``, ``schedule_metrics`` and
  ``select_schedule``'s reports on ``desim``, ``analytical`` and
  ``desim-cluster``;
* ``evaluate_schedule``'s cycles, per-step spans and span-log digest;
* the int8 outputs of a schedule executed with operands on ``desim`` and
  ``desim-cluster`` (the kernels' plain versions, on the CPU) equal the
  reference's ``execute_workload_jax`` bit for bit, the operands carried
  across through numpy.
"""

import hashlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.serving import scheduler as jsch               # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs.registry import get_config      # noqa: E402
from repro_torch.serving import scheduler as tsch         # noqa: E402
from repro_torch.serving.engine import ServingEngine     # noqa: E402

ARCH = "yi-6b"
BACKENDS = (("desim", 1), ("analytical", 2), ("desim-cluster", 2))


def _engines(lengths=(5, 9, 3, 12, 7), gap=0.0, max_batch=2):
    je = JEngine(j_get_config(ARCH, reduced=True), None, max_batch=max_batch)
    te = ServingEngine(get_config(ARCH, reduced=True), None,
                       max_batch=max_batch)
    for i, n in enumerate(lengths):
        je.submit(jnp.zeros(n, jnp.int32), arrival_time=i * gap)
        te.submit(torch.zeros(n, dtype=torch.int32), arrival_time=i * gap)
    return je, te


def _ctx(mod, cfg, **kw):
    base = dict(prompt_lengths=(5, 9, 3, 12, 7), max_batch=2,
                max_new_tokens=4)
    return mod.PolicyContext(cfg=cfg, **{**base, **kw})


CONTEXTS = {
    "plain": {},
    "arrivals": dict(arrival_times=(0.0, 10.0, 2e3, 4e3, 4e3)),
    "carryover": dict(prefill_progress=(5, 4, 0, 12, 0),
                      decode_done=(1, 0, 0, 3, 0)),
    "kv": dict(kv_residency=(1.0, 0.5, 0.0, 0.25, 1.0),
               kv_refill_bytes=(0.0, 4096.0, 0.0, 512.0, 0.0)),
    "units": dict(units=2),
}


def test_policy_registries_equal():
    assert tsch.available_policies() == jsch.available_policies()


@pytest.mark.parametrize("ctx_name", list(CONTEXTS))
@pytest.mark.parametrize("policy,kw", [
    ("full-prefill", {}), ("chunked-prefill", {}),
    ("chunked-prefill", {"chunk_tokens": 4}), ("decode-priority", {}),
    ("decode-priority", {"chunk_tokens": 8})])
def test_policy_steps_and_layers_equal(policy, kw, ctx_name):
    jc = _ctx(jsch, j_get_config(ARCH, reduced=True), **CONTEXTS[ctx_name])
    tc = _ctx(tsch, get_config(ARCH, reduced=True), **CONTEXTS[ctx_name])
    js = jsch.get_policy(policy, **kw).schedule(jc)
    ts = tsch.get_policy(policy, **kw).schedule(tc)
    assert repr(ts) == repr(js)
    assert ts.step_deps() == js.step_deps()
    assert list(ts.gemm_tasks()) == list(js.gemm_tasks())


@pytest.mark.parametrize("name,units", BACKENDS)
@pytest.mark.parametrize("policy", ("full-prefill", "chunked-prefill",
                                    "decode-priority"))
def test_prices_and_latency_stats_equal(name, units, policy):
    je, te = _engines(gap=3000.0)
    js = je.plan(4, units=units, policy=policy, overlap="relaxed")
    ts = te.plan(4, units=units, policy=policy, overlap="relaxed")
    assert repr(ts) == repr(js)
    jcyc, tcyc = jsch.price_steps(js, name), tsch.price_steps(ts, name)
    assert tcyc == jcyc
    n = te.cfg.n_layers
    assert (tsch.decode_latency_stats(ts, tcyc, n)
            == jsch.decode_latency_stats(js, jcyc, n))
    assert tsch.schedule_timeline(ts, tcyc) == jsch.schedule_timeline(js,
                                                                      jcyc)
    assert (tsch.schedule_metrics(ts, n, name)
            == jsch.schedule_metrics(js, n, name))


def test_select_schedule_reports_equal():
    for units in (1, 2):
        jc = _ctx(jsch, j_get_config(ARCH, reduced=True), units=units,
                  arrival_times=(0.0, 0.0, 500.0, 900.0, 900.0))
        tc = _ctx(tsch, get_config(ARCH, reduced=True), units=units,
                  arrival_times=(0.0, 0.0, 500.0, 900.0, 900.0))
        js, jrep = jsch.select_schedule(jc)
        ts, trep = tsch.select_schedule(tc)
        assert repr(ts) == repr(js)
        assert trep == jrep
        js, jrep = jsch.select_schedule(jc, objective="ttft_p99",
                                        policy_kw={"chunk_tokens": 4})
        ts, trep = tsch.select_schedule(tc, objective="ttft_p99",
                                        policy_kw={"chunk_tokens": 4})
        assert repr(ts) == repr(js) and trep == jrep


def _digest(log):
    return hashlib.sha256(json.dumps(log.to_json(), sort_keys=True)
                          .encode()).hexdigest()


@pytest.mark.parametrize("name,units", BACKENDS)
@pytest.mark.parametrize("policy", ("full-prefill", "auto"))
def test_evaluate_schedule_equal(name, units, policy):
    je, te = _engines(gap=2000.0)
    js, jr = je.evaluate_schedule(name, max_new_tokens=4, units=units,
                                  policy=policy)
    ts, tr = te.evaluate_schedule(name, max_new_tokens=4, units=units,
                                  policy=policy)
    assert repr(ts) == repr(js)
    assert (tr.cycles, tr.seconds, tr.utilization) == (jr.cycles,
                                                       jr.seconds,
                                                       jr.utilization)
    assert tr.detail["workload"] == jr.detail["workload"]
    if "step_spans" in jr.detail:
        assert tr.detail["step_spans"] == jr.detail["step_spans"]
        assert _digest(tr.detail["span_log"]) == _digest(
            jr.detail["span_log"])
        assert tr.detail["span_log"].validate() == []
    else:
        assert "step_spans" not in tr.detail


@pytest.mark.parametrize("name,units", [("desim", 1), ("desim-cluster", 2)])
def test_executed_int8_outputs_equal_the_reference(name, units):
    je, te = _engines(lengths=(5, 9, 3))
    js = je.plan(3, units=units, policy="chunked-prefill",
                 chunk_tokens=8)
    ts = te.plan(3, units=units, policy="chunked-prefill",
                 chunk_tokens=8)
    assert repr(ts) == repr(js)
    jops = js.example_operands(jax.random.PRNGKey(3))
    tops = {k: tuple(torch.from_numpy(np.array(x)) for x in v)
            for k, v in jops.items()}
    jr = je.run_schedule(js, name, operands=jops, workload=False)
    tr = te.run_schedule(ts, name, operands=tops, workload=False)
    assert tr.cycles == jr.cycles
    assert list(tr.outputs) == list(jr.outputs)
    for label, out in tr.outputs.items():
        assert out.dtype == torch.int32
        assert np.array_equal(out.numpy(), np.asarray(jr.outputs[label]))
        a, b = tops[label]
        assert torch.equal(out, a.int() @ b.int())


def test_example_operands_depend_on_seed_and_label_only():
    _, te = _engines()
    s3 = te.plan(3)
    te.submit(torch.zeros(4, dtype=torch.int32))
    s4 = te.plan(3)
    o3, o4 = s3.example_operands(1), s4.example_operands(1)
    shared = set(o3) & set(o4)
    assert shared and set(o3) <= set(o4)
    for label in shared:
        t = s3.gemm_tasks()[label]
        a, b = o3[label]
        assert a.shape == (t.m, t.k) and b.shape == (t.k, t.n)
        assert a.dtype == b.dtype == torch.int8
        assert int(a.min()) >= -8 and int(a.max()) < 8
        if s4.gemm_tasks()[label] == t:
            assert all(torch.equal(x, y)
                       for x, y in zip(o3[label], o4[label]))
    other = s3.example_operands(2)
    assert any(not torch.equal(o3[k][1], other[k][1]) for k in o3)
