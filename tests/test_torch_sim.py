"""The port's simulators against the reference's, on the same parameters.

``repro_torch.core.simulator`` (the analytical model), ``sim.graph``,
``sim.resources``/``sim.desim`` (the discrete-event machine),
``sim.partition`` and ``sim.trace`` are copies of the reference's pure
Python.  Each case builds its inputs in each package from the same
parameters and compares the results by value with ``==``: dicts of
cycles, every node's span, every resource interval, the partitioned
graphs and the Chrome-trace JSON text.  Nothing of one package is passed
into the other.
"""

import dataclasses
import json
import types

import pytest

pytest.importorskip("torch")

from repro.core import config as j_config                      # noqa: E402
from repro.core import hardware as j_hw                        # noqa: E402
from repro.core import simulator as j_simulator                # noqa: E402
from repro.core import task as j_task                          # noqa: E402
from repro.core.precision import DataType as JDataType         # noqa: E402
from repro.sim import desim as j_desim                         # noqa: E402
from repro.sim import graph as j_graph                         # noqa: E402
from repro.sim import lower as j_lower                         # noqa: E402
from repro.sim import partition as j_partition                 # noqa: E402
from repro.sim import resources as j_resources                 # noqa: E402
from repro.sim import trace as j_trace                         # noqa: E402
from repro_torch.core import config as t_config                # noqa: E402
from repro_torch.core import hardware as t_hw                  # noqa: E402
from repro_torch.core import simulator as t_simulator          # noqa: E402
from repro_torch.core import task as t_task                    # noqa: E402
from repro_torch.core.precision import DataType as TDataType   # noqa: E402
from repro_torch.sim import desim as t_desim                   # noqa: E402
from repro_torch.sim import graph as t_graph                   # noqa: E402
from repro_torch.sim import lower as t_lower                   # noqa: E402
from repro_torch.sim import partition as t_partition           # noqa: E402
from repro_torch.sim import resources as t_resources           # noqa: E402
from repro_torch.sim import trace as t_trace                   # noqa: E402

# One namespace per package, so every case is written once.
J = types.SimpleNamespace(config=j_config, hw=j_hw, sim=j_simulator,
                          task=j_task, DataType=JDataType, desim=j_desim,
                          graph=j_graph, lower=j_lower,
                          partition=j_partition, resources=j_resources,
                          trace=j_trace)
T = types.SimpleNamespace(config=t_config, hw=t_hw, sim=t_simulator,
                          task=t_task, DataType=TDataType, desim=t_desim,
                          graph=t_graph, lower=t_lower,
                          partition=t_partition, resources=t_resources,
                          trace=t_trace)
PKGS = (J, T)


def _task(p, m, n, k, dtype="int8", bias="zero", **kw):
    return p.task.MatMulTask(m=m, n=n, k=k, data_type=p.DataType(dtype),
                             bias_type=p.task.BiasType(bias), **kw)


def _layer(p, name="linear+silu", gemms=((512, 512, 2048),),
           vec_elems=512 * 512, repeat=1, inter=None):
    return p.sim.LayerTrace(
        name=name, gemms=tuple(_task(p, *g) for g in gemms),
        vector_ops={"silu": vec_elems, "quant": vec_elems},
        intermediate_bytes=vec_elems * 4.0 if inter is None else inter,
        repeat=repeat)


def _value(x):
    """A value with no object of either package in it: enums by their
    value, dataclasses as dicts, containers element by element."""
    if isinstance(x, (str, int, float, bool)) or x is None:
        return x
    if hasattr(x, "value") and type(x).__module__.startswith("repro"):
        return x.value                       # DataType, BiasType, Status
    if dataclasses.is_dataclass(x):
        return {f.name: _value(getattr(x, f.name))
                for f in dataclasses.fields(x)
                if f.name not in ("topology",)}
    if isinstance(x, dict):
        return {_value(k): _value(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_value(v) for v in x)
    raise TypeError(f"no value form for {type(x)}")


def _graph_value(graph):
    return [(n.nid, n.kind, n.name, n.deps, n.layer, n.unit, n.release_time,
             _value(n.task), _value(n.tile), dict(n.vector_ops),
             n.mem_bytes) for n in graph.nodes]


def _desim_value(r):
    out = {"cycles": r.cycles, "ideal": r.ideal_matrix_cycles,
           "node_span": dict(r.node_span), "intervals": r.intervals,
           "capacity": r.capacity, "freq_hz": r.freq_hz,
           "matrix_utilization": r.matrix_utilization,
           "utilizations": r.utilizations()}
    if hasattr(r, "n_units"):
        out.update(n_units=r.n_units, loader_busy=r.loader_busy,
                   unit_utilizations=r.unit_utilizations())
    return out


# ---------------------------------------------------------------------------
# core.simulator: the cases of tests/test_simulator.py.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("platform", sorted(j_hw.PLATFORMS))
@pytest.mark.parametrize("k", [256, 512, 1024, 2048, 4096, 8192])
def test_simulate_gemm_fig6(platform, k):
    def run(p):
        r = p.sim.simulate_gemm(p.config.PLATFORM_2TOPS,
                                _task(p, 512, 512, k),
                                p.hw.PLATFORMS[platform])
        return _value(r)
    assert run(J) == run(T)


@pytest.mark.parametrize("bias", ["zero", "row", "full"])
@pytest.mark.parametrize("shape", [(512, 512, 4096), (512, 512, 256),
                                   (64, 64, 64), (100, 96, 200)])
def test_simulate_gemm_case_study(shape, bias):
    def run(p):
        r = p.sim.simulate_gemm(p.config.CASE_STUDY, _task(p, *shape,
                                                           bias=bias),
                                p.hw.SHUTTLE)
        return (_value(r), r.utilization, r.seconds(2e9))
    assert run(J) == run(T)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("k", [512, 2048])
def test_simulate_layer_and_workload(fused, k):
    def run(p):
        layer = _layer(p, gemms=((512, 512, k),))
        big = _layer(p, "big", gemms=((512, 512, k), (512, 1024, 512)),
                     vec_elems=4 * 2 ** 20, repeat=3)
        unit = p.config.CASE_STUDY
        return (p.sim.simulate_layer(unit, layer, fused=fused),
                p.sim.simulate_workload(unit, [layer, big], fused=fused),
                p.sim.simulate_workload(p.config.PLATFORM_2TOPS, [big],
                                        platform=p.hw.KUNMINGHU,
                                        fused=fused))
    assert run(J) == run(T)


@pytest.mark.parametrize("workload", [None, "llama3", "resnet50"])
def test_baseline_seconds(workload):
    def run(p):
        layers = [_layer(p), _layer(p, "big", vec_elems=4 * 2 ** 20)]
        return [p.sim.baseline_workload_seconds(p.hw.XEON_8580, layers,
                                                workload=workload),
                p.sim.SATURN_512.cycles_for({"softmax": 1e6, "silu": 3e5,
                                             "layernorm": 7.0})]
    assert run(J) == run(T)


def test_vector_tables_equal():
    assert j_simulator.VECTOR_OP_INSTRS == t_simulator.VECTOR_OP_INSTRS
    assert j_simulator.DIV_OPS == t_simulator.DIV_OPS
    assert _value(j_simulator.SATURN_512) == _value(t_simulator.SATURN_512)


# ---------------------------------------------------------------------------
# The discrete-event machine.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gran", ["tile", "panel", "layer"])
@pytest.mark.parametrize("shape", [(256, 256, 1024), (100, 96, 200),
                                   (512, 512, 4096)])
def test_desim_single_gemm(gran, shape):
    def run(p):
        graph, sinks = p.graph.build_gemm_graph(
            _task(p, *shape), 64, 64,
            granularity=p.graph.Granularity(gran),
            vector_ops={"relu": float(shape[0] * shape[1])})
        r = p.desim.simulate_graph(graph, p.config.CASE_STUDY, p.hw.SHUTTLE,
                                   p.sim.SATURN_512)
        return (_graph_value(graph), [s.nid for s in sinks], graph.stats(),
                _desim_value(r))
    assert run(J) == run(T)


@pytest.mark.parametrize("platform", ["shuttle", "kunminghu"])
def test_desim_gemm_and_exposed_dispatch(platform):
    def run(p):
        plat = p.hw.PLATFORMS[platform]
        task = _task(p, 128, 192, 512, dtype="bf16", bias="row")
        return (_desim_value(p.lower.desim_gemm(p.config.CASE_STUDY, task,
                                                plat)),
                p.lower.exposed_dispatch(p.config.PLATFORM_2TOPS,
                                         _task(p, 64, 64, 64), plat))
    assert run(J) == run(T)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("gran", ["tile", "panel", "layer"])
def test_desim_layers_with_spill(fused, gran):
    """Unfused, an intermediate beyond the L2 round-trips DRAM as a
    memory node."""
    def run(p):
        g = p.graph.Granularity(gran)
        spill = _layer(p, "spill", gemms=((256, 512, 256), (256, 256, 512)),
                       vec_elems=256 * 512, inter=8.0 * 2 ** 20, repeat=2)
        layer = _layer(p, gemms=((128, 256, 512),))
        graph, sinks = p.lower.layer_to_graph(p.config.CASE_STUDY, spill,
                                              fused=fused, granularity=g)
        d = p.lower.desim_layer(p.config.CASE_STUDY, spill, fused=fused,
                                granularity=g)
        d["result"] = _desim_value(d["result"])
        w = p.lower.desim_workload(p.config.CASE_STUDY, [layer, spill],
                                   fused=fused, granularity=g)
        return (_graph_value(graph), [s.nid for s in sinks], d, w)
    ref, port = run(J), run(T)
    assert ref == port
    kinds = [n[1] for n in port[0]]
    assert ("memory" in kinds) == (not fused)


def _two_steps(p):
    prefill = _layer(p, "b0/prefill", gemms=((96, 256, 128),
                                             (96, 128, 256)),
                     vec_elems=96 * 256, repeat=2)
    decode = _layer(p, "b0/decode", gemms=((4, 256, 128), (4, 128, 256)),
                    vec_elems=4 * 256, repeat=3)
    other = _layer(p, "b1/prefill", gemms=((64, 256, 128),),
                   vec_elems=64 * 256)
    return [prefill, decode, other]


@pytest.mark.parametrize("overlap", ["chained", "relaxed"])
@pytest.mark.parametrize("fused", [True, False])
def test_workload_to_graph_steps(overlap, fused):
    def run(p):
        kw = {}
        if overlap == "relaxed":
            kw = dict(step_deps=[(), (0,), ()],
                      release_times=[0.0, 0.0, 5000.0],
                      refill_bytes=[0.0, 4096.0, 0.0])
        graph = p.lower.workload_to_graph(
            p.config.CASE_STUDY, _two_steps(p), fused=fused,
            granularity=p.graph.Granularity.PANEL, overlap=overlap, **kw)
        r = p.desim.simulate_graph(graph, p.config.CASE_STUDY)
        return (_graph_value(graph), _desim_value(r),
                p.lower.step_spans(graph, r), p.lower.gemm_labels(graph))
    assert run(J) == run(T)


@pytest.mark.parametrize("bad", [dict(overlap="eager"),
                                 dict(overlap="relaxed"),
                                 dict(overlap="relaxed", step_deps=[(), (2,),
                                                                    ()])])
def test_workload_to_graph_rejects(bad):
    for p in PKGS:
        with pytest.raises(ValueError):
            p.lower.workload_to_graph(p.config.CASE_STUDY, _two_steps(p),
                                      **bad)


@pytest.mark.parametrize("n_units", [2, 4])
@pytest.mark.parametrize("strategy", list(j_partition.STRATEGIES))
def test_cluster_workload_and_partition(n_units, strategy):
    def run(p):
        assert p.partition.STRATEGIES == j_partition.STRATEGIES
        topo = p.resources.ClusterTopology(n_units=n_units)
        layers = _two_steps(p)
        kw = {}
        if strategy == "unit-affinity":
            kw = dict(affinity={"b0/decode": n_units - 1},
                      weights=[1.0 + i for i in range(n_units)])
        w = p.lower.cluster_workload(topo, layers, strategy=strategy, **kw)
        graph = p.lower.workload_to_graph(
            topo.unit, layers, granularity=p.graph.Granularity.PANEL)
        part = p.partition.partition_graph(graph, n_units, strategy, **kw)
        r = p.desim.simulate_cluster(part.graph, topo)
        return (w, _graph_value(part.graph), part.assignment, part.spans,
                part.unit_of_label, part.n_transfers, part.transfer_bytes,
                [part.balanced(lbl) for lbl in part.spans],
                _desim_value(r), r.aggregate_matrix_utilization,
                r.loader_contention(), topo.describe())
    assert run(J) == run(T)


@pytest.mark.parametrize("policy", ["fair", "fcfs"])
def test_heterogeneous_cluster(policy):
    def run(p):
        small = p.config.CASE_STUDY.with_(m_pe=2)
        topo = p.resources.ClusterTopology(
            unit_specs=(p.resources.UnitSpec(unit=p.config.CASE_STUDY,
                                             private_bandwidth=8e9),
                        p.resources.UnitSpec(unit=small)),
            loader_policy=policy, row_buffer=True, total_bandwidth=64e9)
        graph = p.lower.workload_to_graph(topo.unit, _two_steps(p))
        part = p.partition.partition_graph(graph, 2, "unit-affinity",
                                           weights=topo.throughput_weights())
        return (_desim_value(p.desim.simulate_cluster(part.graph, topo)),
                topo.describe(), topo.interleaved_streams())
    assert run(J) == run(T)


def test_dram_stride_efficiency():
    for runs, streams in [(8.0, 1), (64.0, 1), (640.0, 4), (32.0, 3)]:
        args = (runs, 0.8, streams)
        assert (j_resources.dram_stride_efficiency(*args)
                == t_resources.dram_stride_efficiency(*args))
    assert (j_resources.contiguous_run_bytes(64, 64, 4096, 1.0)
            == t_resources.contiguous_run_bytes(64, 64, 4096, 1.0))


def test_step_layer_graph_at_reduced_width():
    """The serving step the ``exec`` path lowers, at the reduced widths,
    through the DES: same graph, same timeline."""
    from repro.configs.registry import get_config as j_get_config
    from repro.serving.engine import _step_layer as j_step
    from repro_torch.configs.registry import get_config as t_get_config
    from repro_torch.serving.engine import _step_layer as t_step

    def run(p, get_config, step):
        cfg = get_config("yi-6b", reduced=True)
        layers = [step(cfg, "prefill", 24, 2), step(cfg, "decode", 4, 2)]
        graph = p.lower.workload_to_graph(p.config.CASE_STUDY, layers)
        r = p.desim.simulate_graph(graph, p.config.CASE_STUDY)
        return _graph_value(graph), _desim_value(r)
    assert (run(J, j_get_config, j_step) == run(T, t_get_config, t_step))


# ---------------------------------------------------------------------------
# Chrome trace.
# ---------------------------------------------------------------------------

def _schedule(p):
    layers = _two_steps(p)
    steps = [types.SimpleNamespace(requests=(0, 1)),
             types.SimpleNamespace(requests=(0, 1)),
             types.SimpleNamespace(requests=(2,))]
    return types.SimpleNamespace(steps=steps, layers=layers)


@pytest.mark.parametrize("n_units", [1, 2])
@pytest.mark.parametrize("with_schedule", [False, True])
def test_chrome_trace_json(n_units, with_schedule):
    def run(p):
        sched = _schedule(p)
        graph = p.lower.workload_to_graph(p.config.CASE_STUDY, sched.layers)
        if n_units == 1:
            r = p.desim.simulate_graph(graph, p.config.CASE_STUDY)
        else:
            part = p.partition.partition_graph(graph, n_units)
            r = p.desim.simulate_cluster(
                part.graph, p.resources.ClusterTopology(n_units=n_units))
        kw = {"schedule": sched} if with_schedule else {}
        return json.dumps(p.trace.chrome_trace(r, **kw), sort_keys=True)
    ref, port = run(J), run(T)
    assert ref == port
    assert json.loads(port)["traceEvents"]


def test_dump_chrome_trace(tmp_path):
    texts = []
    for p in PKGS:
        graph, _ = p.graph.build_gemm_graph(_task(p, 128, 128, 256), 64, 64)
        r = p.desim.simulate_graph(graph, p.config.CASE_STUDY)
        path = tmp_path / f"{len(texts)}.json"
        p.trace.dump_chrome_trace(r, str(path), process_name="x")
        texts.append(path.read_text())
    assert texts[0] == texts[1]


@pytest.mark.parametrize("label", ["b0/prefill.c2/g0/t0,1", "dp3/decode/x",
                                   "b1/mixed/g1", "gemm/t0,0",
                                   "b0/prefill/g0"])
def test_phase_of(label):
    assert j_trace.phase_of(label) == t_trace.phase_of(label)
