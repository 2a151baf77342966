"""The port's ``Backend`` contract and TaskGraph execution against the
reference's.

``repro_torch.backend`` registers ``"torch"`` (the reference's ``jax``),
``"kernel"`` (its ``pallas``: the CUDA fused matmul, whose wrapper runs
its plain version on these CPU tensors) and ``"desim"``.  The same
numpy operands, drawn from a seed, go through the reference's and the
port's backends: int8 outputs must be equal bit for bit, fp32 within
1e-5 and bf16 within 2e-2 (``tests/test_backend.py``'s tolerances).
Operands cross to the port through ``repro_torch.models.convert``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import backend as j_backend                        # noqa: E402
from repro.core.fusion import Epilogue as JEpilogue           # noqa: E402
from repro.core.fusion import EpilogueOperands as JOperands   # noqa: E402
from repro.core.fusion import cute_matmul as j_cute_matmul    # noqa: E402
from repro.core.precision import DataType as JDataType        # noqa: E402
from repro.core.task import BiasType as JBias                 # noqa: E402
from repro.core.task import MatMulTask as JTask               # noqa: E402
from repro.sim import lower as j_lower                        # noqa: E402
from repro_torch import backend                               # noqa: E402
from repro_torch.core.fusion import Epilogue, EpilogueOperands  # noqa: E402
from repro_torch.core.fusion import cute_matmul               # noqa: E402
from repro_torch.core.precision import DataType               # noqa: E402
from repro_torch.core.task import BiasType, MatMulTask, Status  # noqa: E402
from repro_torch.kernels.matmul import ops as mm_ops          # noqa: E402
from repro_torch.models.convert import to_torch               # noqa: E402
from repro_torch.sim import lower                             # noqa: E402
from repro_torch.sim.graph import Granularity                 # noqa: E402

GRANS = ["tile", "panel", "layer"]
M, N, K = 100, 96, 64          # ragged against the 64 x 64 tiles


def _int8(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.integers(-8, 8, s).astype(np.int8) for s in shapes]


def _task(cls, dtypes, biases, data_type="int8", bias_type="zero", **kw):
    return cls(data_type=dtypes(data_type), bias_type=biases(bias_type),
               **kw)


def _run_both(name_j, name_t, gran, task_kw, a, b, j_ep=None, t_ep=None,
              j_ops=None, t_ops=None):
    """``run_graph`` of one lowered task in each package."""
    je = j_backend.get(name_j, granularity=gran)
    te = backend.get(name_t, granularity=gran)
    jg = je.lower(_task(JTask, JDataType, JBias, **task_kw), epilogue=j_ep)
    tg = te.lower(_task(MatMulTask, DataType, BiasType, **task_kw),
                  epilogue=t_ep)
    jr = je.run_graph(jg, j_backend.MatMulOperands(
        a=jnp.asarray(a), b=jnp.asarray(b), epilogue=j_ops or JOperands()))
    tr = te.run_graph(tg, backend.MatMulOperands(
        a=to_torch(a), b=to_torch(b), epilogue=t_ops or EpilogueOperands()))
    return np.asarray(jr.output), tr.output


# ---------------------------------------------------------------------------
# The registry.
# ---------------------------------------------------------------------------

class TestRegistry:
    def test_available(self):
        assert backend.available() == ("analytical", "desim",
                                       "desim-cluster", "kernel", "sharded",
                                       "torch")

    @pytest.mark.parametrize("alias,canon", [("jax", "torch"),
                                             ("xla", "torch"),
                                             ("pallas", "kernel"),
                                             ("kernel", "kernel"),
                                             ("desim", "desim"),
                                             ("analytic", "analytical")])
    def test_aliases_resolve(self, alias, canon):
        assert backend.resolve(alias) == canon
        assert backend.get(alias).name == canon

    def test_unknown_backend_rejected(self):
        with pytest.raises(KeyError):
            backend.get("verilator")
        with pytest.raises(KeyError):
            backend.set_default_matmul_backend("verilator")

    def test_constructor_kwargs(self):
        b = backend.get("desim", granularity="panel", fused=False)
        assert b.granularity is Granularity.PANEL and not b.fused
        with pytest.raises(ValueError):
            backend.get("kernel", units=2)

    def test_capability_flags(self):
        for name in ("torch", "kernel"):
            b = backend.get(name)
            assert b.executes and not b.models_time
        d = backend.get("desim")
        assert d.executes and d.models_time

    def test_zoo_routes(self):
        assert backend.default_matmul_backend() == "kernel"
        assert backend.matmul_backend_string() == "kernel"
        assert backend.matmul_backend_string("pallas") == "kernel"
        prev = backend.set_default_matmul_backend("jax")
        try:
            assert backend.default_matmul_backend() == "torch"
            assert backend.matmul_backend_string() == "torch"
        finally:
            backend.set_default_matmul_backend(prev)
        assert backend.matmul_backend_string() == "kernel"

    def test_modelling_backends_not_zoo_routable(self):
        with pytest.raises(ValueError):
            backend.set_default_matmul_backend("desim")
        assert backend.default_matmul_backend() == "kernel"

    def test_register_refuses_a_taken_name(self):
        with pytest.raises(ValueError):
            backend.register("kernel")(type("Other", (backend.TorchBackend,),
                                            {}))
        assert backend.register("kernel")(backend.KernelBackend) \
            is backend.KernelBackend


# ---------------------------------------------------------------------------
# asyncMatMul / checkMatmul.
# ---------------------------------------------------------------------------

class TestDispatchContract:
    @pytest.mark.parametrize("name", ["torch", "kernel", "desim"])
    def test_status_register_lifecycle(self, name):
        task = MatMulTask(m=64, n=64, k=128)
        eng = backend.get(name)
        a, b = _int8(0, (64, 128), (128, 64))
        ops = (backend.MatMulOperands(to_torch(a), to_torch(b))
               if name != "desim" else None)
        assert task.status is Status.IDLE
        h = eng.dispatch(task, ops)
        assert task.status is Status.RUNNING
        assert not eng.check(h) and not h.done()
        r = eng.wait(h)
        assert task.status is Status.DONE
        assert eng.check(h) and h.done()
        assert (r.output is not None) == (name != "desim")
        assert (r.cycles is not None) == (name == "desim")
        if r.output is not None:
            ref = np.asarray(j_cute_matmul(jnp.asarray(a), jnp.asarray(b),
                                           backend="xla"))
            assert np.array_equal(r.output.numpy(), ref)

    @pytest.mark.parametrize("name", ["torch", "kernel", "desim"])
    def test_drain_forces_all(self, name):
        eng = backend.get(name)
        a, b = _int8(1, (64, 128), (128, 64))
        ops = backend.MatMulOperands(to_torch(a), to_torch(b))
        for _ in range(3):
            eng.dispatch(MatMulTask(m=64, n=64, k=128), ops)
        out = eng.drain()
        assert len(out) == 3 and not eng.dispatched
        assert all(r.output is not None for r in out)
        assert all((r.cycles is not None) == (name == "desim") for r in out)

    @pytest.mark.parametrize("name", ["torch", "kernel"])
    def test_executing_backend_requires_operands(self, name):
        with pytest.raises(ValueError):
            backend.get(name).dispatch(MatMulTask(m=8, n=8, k=8))
        graph = backend.get(name).lower(MatMulTask(m=8, n=8, k=8))
        with pytest.raises(ValueError):
            backend.get(name).run_graph(graph)

    def test_desim_dispatch_cycles_equal_reference(self):
        for task_kw in (dict(m=512, n=512, k=4096), dict(m=M, n=N, k=K)):
            jr = j_backend.get("desim").wait(
                j_backend.get("desim").dispatch(JTask(**task_kw)))
            tr = backend.get("desim").wait(
                backend.get("desim").dispatch(MatMulTask(**task_kw)))
            assert (tr.cycles, tr.utilization, tr.seconds) == \
                (jr.cycles, jr.utilization, jr.seconds)
            assert tr.detail["step_spans"] == jr.detail["step_spans"]

    def test_run_workload_equals_reference(self):
        from repro.core.simulator import LayerTrace as JLayer
        from repro_torch.core.simulator import LayerTrace
        jl = [JLayer("l", (JTask(m=128, n=256, k=512),),
                     vector_ops={"silu": 128 * 256.0}, repeat=2)]
        tl = [LayerTrace("l", (MatMulTask(m=128, n=256, k=512),),
                         vector_ops={"silu": 128 * 256.0}, repeat=2)]
        for gran in GRANS:
            assert (backend.get("desim", granularity=gran).run_workload(tl)
                    == j_backend.get("desim",
                                     granularity=gran).run_workload(jl))
        with pytest.raises(NotImplementedError):
            backend.get("kernel").run_workload(tl)

    @pytest.mark.parametrize("gran,n_vec", [("tile", 8), ("panel", 2),
                                            ("layer", 1)])
    def test_lower_granularity(self, gran, n_vec):
        eng = backend.get("desim", granularity=gran)
        ep = Epilogue(activation="relu", out_dtype=torch.float32)
        graph = eng.lower(MatMulTask(m=128, n=256, k=64), epilogue=ep)
        assert len(graph.matmul_nodes()) == 2 * 4
        assert len(graph.vector_nodes()) == n_vec
        jgraph = j_backend.get("desim", granularity=gran).lower(
            JTask(m=128, n=256, k=64),
            epilogue=JEpilogue(activation="relu", out_dtype=jnp.float32))
        assert ([(n.kind, n.name, n.deps, n.vector_ops)
                 for n in graph.nodes]
                == [(n.kind, n.name, n.deps, n.vector_ops)
                    for n in jgraph.nodes])

    def test_lower_refuses_epilogue_on_a_workload(self):
        from repro_torch.core.simulator import LayerTrace
        layer = LayerTrace("l", (MatMulTask(m=8, n=8, k=8),))
        with pytest.raises(ValueError):
            backend.get("kernel").lower([layer], epilogue=Epilogue())


# ---------------------------------------------------------------------------
# run_graph: the port against the reference.
# ---------------------------------------------------------------------------

class TestExecutionParity:
    @pytest.mark.parametrize("name", ["torch", "kernel", "desim"])
    @pytest.mark.parametrize("gran", GRANS)
    @pytest.mark.parametrize("epilogue", [False, True])
    def test_int8_bit_exact_against_jax(self, name, gran, epilogue):
        """Raw accumulators (no vector node carries an epilogue) and an
        int32 epilogue at each granularity, on ragged tiles."""
        a, b = _int8(2, (M, K), (K, N))
        jep = JEpilogue(out_dtype=jnp.int32) if epilogue else None
        tep = Epilogue(out_dtype=torch.int32) if epilogue else None
        ref, out = _run_both("jax", name, gran, dict(m=M, n=N, k=K), a, b,
                             jep, tep)
        assert out.dtype == torch.int32 and ref.dtype == np.int32
        assert np.array_equal(out.numpy(), ref)
        direct = cute_matmul(to_torch(a), to_torch(b), backend="torch")
        assert torch.equal(out, direct)

    def test_int8_bit_exact_against_pallas(self):
        """The reference's Pallas kernel in interpret mode, tile by tile."""
        a, b = _int8(3, (M, K), (K, N))
        ref, out = _run_both("pallas", "kernel", "tile",
                             dict(m=M, n=N, k=K), a, b)
        assert np.array_equal(out.numpy(), ref)

    @pytest.mark.parametrize("name", ["torch", "kernel", "desim"])
    @pytest.mark.parametrize("gran", GRANS)
    def test_fp32_epilogue(self, name, gran):
        """Bias, dequant scales, gelu and a residual on fp32 operands."""
        rng = np.random.default_rng(4)
        a = rng.standard_normal((M, K)).astype(np.float32)
        b = (rng.standard_normal((K, N)) / 8).astype(np.float32)
        bias = rng.standard_normal(N).astype(np.float32)
        sa = rng.uniform(0.5, 1.5, M).astype(np.float32)
        sb = rng.uniform(0.5, 1.5, N).astype(np.float32)
        res = rng.standard_normal((M, N)).astype(np.float32)
        kw = dict(bias_type=BiasType.ROW, activation="gelu",
                  has_scale_a=True, has_scale_b=True, has_residual=True)
        jep = JEpilogue(**{**kw, "bias_type": JBias.ROW},
                        out_dtype=jnp.float32)
        tep = Epilogue(**kw, out_dtype=torch.float32)
        jops = JOperands(bias=jnp.asarray(bias), scale_a=jnp.asarray(sa),
                         scale_b=jnp.asarray(sb), residual=jnp.asarray(res))
        tops = EpilogueOperands(bias=to_torch(bias), scale_a=to_torch(sa),
                                scale_b=to_torch(sb),
                                residual=to_torch(res))
        ref, out = _run_both("jax", name, gran,
                             dict(m=M, n=N, k=K, data_type="fp32"),
                             a, b, jep, tep, jops, tops)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
        direct = cute_matmul(to_torch(a), to_torch(b), epilogue=tep,
                             operands=tops, backend="torch")
        np.testing.assert_allclose(out.numpy(), direct.numpy(), rtol=1e-5,
                                   atol=1e-5)

    @pytest.mark.parametrize("name", ["torch", "kernel"])
    def test_int8_full_bias_dequant(self, name):
        """int8 operands, a full bias and dequant scales into fp32."""
        a, b = _int8(5, (M, K), (K, N))
        rng = np.random.default_rng(5)
        bias = rng.standard_normal((M, N)).astype(np.float32)
        sa = rng.uniform(0.01, 0.02, M).astype(np.float32)
        kw = dict(has_scale_a=True)
        jep = JEpilogue(bias_type=JBias.FULL, out_dtype=jnp.float32, **kw)
        tep = Epilogue(bias_type=BiasType.FULL, out_dtype=torch.float32,
                       **kw)
        ref, out = _run_both(
            "jax", name, "panel", dict(m=M, n=N, k=K, bias_type="full"),
            a, b, jep, tep,
            JOperands(bias=jnp.asarray(bias), scale_a=jnp.asarray(sa)),
            EpilogueOperands(bias=to_torch(bias), scale_a=to_torch(sa)))
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("name", ["torch", "kernel", "desim"])
    @pytest.mark.parametrize("gran", ["panel", "layer"])
    def test_bf16_glu(self, name, gran):
        """GLU on a 2-D B: gate columns, then up columns."""
        rng = np.random.default_rng(6)
        n = 2 * 96
        a = rng.standard_normal((M, 128)).astype(jnp.bfloat16)
        b = (rng.standard_normal((128, n)) / 8).astype(jnp.bfloat16)
        jep = JEpilogue(activation="silu", glu=True, out_dtype=jnp.bfloat16)
        tep = Epilogue(activation="silu", glu=True, out_dtype=torch.bfloat16)
        ref, out = _run_both("jax", name, gran,
                             dict(m=M, n=n, k=128, data_type="bf16"),
                             a, b, jep, tep)
        assert out.dtype == torch.bfloat16 and out.shape == (M, 96)
        ref = ref.astype(np.float32)
        scale = np.abs(ref).max()
        assert np.abs(out.float().numpy() - ref).max() <= 2e-2 * scale
        direct = cute_matmul(to_torch(a), to_torch(b), epilogue=tep)
        assert (out.float() - direct.float()).abs().max() <= 2e-2 * scale

    def test_glu_at_tile_raises(self):
        a = torch.zeros((64, 32))
        b = torch.zeros((32, 256))
        for name in ("torch", "kernel"):
            eng = backend.get(name, granularity="tile")
            graph = eng.lower(MatMulTask(m=64, n=256, k=32,
                                         data_type=DataType.FP32),
                              epilogue=Epilogue(glu=True))
            with pytest.raises(ValueError, match="full-N"):
                eng.run_graph(graph, backend.MatMulOperands(a, b))

    def test_multi_gemm_graph_raises(self):
        from repro_torch.core.simulator import LayerTrace
        layer = LayerTrace("l", (MatMulTask(m=8, n=8, k=8),
                                 MatMulTask(m=8, n=8, k=8)))
        graph = backend.get("kernel").lower([layer])
        a = torch.zeros((8, 8), dtype=torch.int8)
        with pytest.raises(ValueError, match="single-GEMM"):
            lower.execute_graph_torch(graph, a, a)
        with pytest.raises(ValueError, match="no matmul"):
            lower.execute_graph_torch(lower.TaskGraph(), a, a)

    def test_apply_graph_epilogues_matches_execution(self):
        rng = np.random.default_rng(7)
        a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
        b = torch.from_numpy(rng.standard_normal((K, 2 * N))
                             .astype(np.float32))
        ep = Epilogue(activation="relu", glu=True, out_dtype=torch.float32)
        eng = backend.get("torch", granularity="panel")
        task = MatMulTask(m=M, n=2 * N, k=K, data_type=DataType.FP32)
        graph = eng.lower(task, epilogue=ep)
        out = eng.run_graph(graph, backend.MatMulOperands(a, b)).output
        acc = a @ b
        assert torch.equal(lower.apply_graph_epilogues(graph, acc), out)
        bare = eng.lower(MatMulTask(m=M, n=2 * N, k=K,
                                    data_type=DataType.FP32))
        assert torch.equal(lower.apply_graph_epilogues(bare, acc), acc)
        assert torch.equal(lower.apply_graph_epilogues(
            bare, acc, in_dtype=torch.bfloat16), acc.to(torch.bfloat16))

    def test_tiles_are_released(self):
        eng = backend.get("kernel")
        a, b = _int8(8, (M, K), (K, N))
        graph = eng.lower(MatMulTask(m=M, n=N, k=K))
        eng.run_graph(graph, backend.MatMulOperands(to_torch(a),
                                                     to_torch(b)))
        assert not eng._engine.dispatched


# ---------------------------------------------------------------------------
# A serving step's workload, GEMM by GEMM.
# ---------------------------------------------------------------------------

def _step_layers(pkg):
    if pkg == "jax":
        from repro.configs.registry import get_config
        from repro.serving.engine import _step_layer
    else:
        from repro_torch.configs.registry import get_config
        from repro_torch.serving.engine import _step_layer
    cfg = get_config("yi-6b", reduced=True)
    return [_step_layer(cfg, "b0/prefill", 24, cfg.n_layers),
            _step_layer(cfg, "b0/decode", 4, cfg.n_layers)]


def test_step_layer_equals_reference():
    for jl, tl in zip(_step_layers("jax"), _step_layers("torch")):
        assert (jl.name, jl.vector_ops, jl.intermediate_bytes, jl.repeat,
                jl.flops()) == (tl.name, tl.vector_ops,
                                tl.intermediate_bytes, tl.repeat, tl.flops())
        assert len(jl.gemms) == len(tl.gemms) == 4
        for jt, tt in zip(jl.gemms, tl.gemms):
            jd, td = dataclasses.asdict(jt), dataclasses.asdict(tt)
            assert jd.keys() == td.keys()
            for key in jd:
                jv, tv = jd[key], td[key]
                assert getattr(jv, "value", jv) == getattr(tv, "value", tv)


@pytest.mark.parametrize("name", ["torch", "kernel", "desim"])
def test_step_workload_bit_exact(name):
    """Two reduced serving steps lowered by the registry and executed GEMM
    by GEMM: the port's ``execute_workload_torch`` (through each backend)
    against the reference's ``execute_workload_jax``."""
    jeng, teng = j_backend.get("jax"), backend.get(name)
    jgraph = jeng.lower(_step_layers("jax"))
    tgraph = teng.lower(_step_layers("torch"))
    labels = lower.gemm_labels(tgraph)
    assert labels == j_lower.gemm_labels(jgraph) and len(labels) == 8
    rng = np.random.default_rng(9)
    arrays = {}
    for node in tgraph.matmul_nodes():
        if node.layer not in arrays:
            t = _full_task(tgraph, node.layer)
            arrays[node.layer] = (
                rng.integers(-8, 8, (t[0], t[2])).astype(np.int8),
                rng.integers(-8, 8, (t[2], t[1])).astype(np.int8))
    jouts = j_lower.execute_workload_jax(
        jgraph, {k: (jnp.asarray(a), jnp.asarray(b))
                 for k, (a, b) in arrays.items()})
    r = teng.run_graph(tgraph, {k: (to_torch(a), to_torch(b))
                                for k, (a, b) in arrays.items()})
    assert list(r.outputs) == list(jouts) == labels
    for label in labels:
        assert np.array_equal(r.outputs[label].numpy(),
                              np.asarray(jouts[label])), label
    if name == "desim":
        jr = j_backend.get("desim").run_graph(jgraph)
        assert (r.cycles, r.utilization) == (jr.cycles, jr.utilization)
        assert r.detail == jr.detail


def _full_task(graph, label):
    tiles = [n for n in graph.matmul_nodes() if n.layer == label]
    return (max(t.tile.m0 + t.tile.m for t in tiles),
            max(t.tile.n0 + t.tile.n for t in tiles), tiles[0].task.k)


def test_kernel_backend_counts_no_launch_on_cpu():
    """On CPU tensors the kernel route runs the plain version: nothing is
    launched or counted."""
    before = mm_ops.fused_matmul.launches
    eng = backend.get("kernel")
    a, b = _int8(10, (M, K), (K, N))
    eng.run_graph(eng.lower(MatMulTask(m=M, n=N, k=K)),
                  backend.MatMulOperands(to_torch(a), to_torch(b)))
    assert mm_ops.fused_matmul.launches == before


# ---------------------------------------------------------------------------
# The analytical and cluster backends.
# ---------------------------------------------------------------------------

class TestAnalyticalAndCluster:
    def test_analytic_alias_resolves_as_in_the_reference(self):
        assert backend.resolve("analytic") == j_backend.resolve("analytic") \
            == "analytical"
        assert backend.get("analytic").name == "analytical"

    @pytest.mark.parametrize("name", ["analytical", "desim-cluster"])
    def test_capability_flags_equal_the_reference(self, name):
        t, j = backend.get(name, units=2), j_backend.get(name, units=2)
        for flag in ("executes", "models_time", "supports_units", "units"):
            assert getattr(t, flag) == getattr(j, flag), flag
        with pytest.raises(ValueError):
            backend.get(name, units=2, strategy="diagonal")

    @pytest.mark.parametrize("units,strategy", [(1, "row-panel"),
                                                (2, "row-panel"),
                                                (4, "output-tile"),
                                                (3, "layer-pipeline")])
    @pytest.mark.parametrize("name", ["analytical", "desim-cluster"])
    def test_cycles_equal_the_reference(self, name, units, strategy):
        for task_kw in (dict(m=512, n=512, k=4096), dict(m=M, n=N, k=K)):
            je = j_backend.get(name, units=units, strategy=strategy)
            te = backend.get(name, units=units, strategy=strategy)
            jr = je.run_graph(je.lower(JTask(**task_kw)))
            tr = te.run_graph(te.lower(MatMulTask(**task_kw)))
            assert (tr.cycles, tr.utilization, tr.seconds) == \
                (jr.cycles, jr.utilization, jr.seconds)
            assert tr.detail == jr.detail or name == "desim-cluster"
            if name == "desim-cluster":
                for key in ("utilizations", "unit_utilizations",
                            "loader_utilization", "loader_contention",
                            "step_spans", "partition"):
                    assert tr.detail[key] == jr.detail[key], key

    @pytest.mark.parametrize("gran", GRANS)
    def test_cluster_executes_int8_bit_exact(self, gran):
        a, b = _int8(7, (M, K), (K, N))
        task_kw = dict(m=M, n=N, k=K)
        je = j_backend.get("desim-cluster", units=2, strategy="output-tile",
                           granularity=gran)
        te = backend.get("desim-cluster", units=2, strategy="output-tile",
                         granularity=gran)
        jr = je.run_graph(je.lower(JTask(**task_kw)), j_backend.MatMulOperands(
            a=jnp.asarray(a), b=jnp.asarray(b)))
        tr = te.run_graph(te.lower(MatMulTask(**task_kw)),
                          backend.MatMulOperands(a=to_torch(a),
                                                 b=to_torch(b)))
        assert tr.cycles == jr.cycles
        assert np.array_equal(tr.output.numpy(), np.asarray(jr.output))

    def test_analytical_returns_cycles_without_numbers(self):
        te, je = backend.get("analytical"), j_backend.get("analytical")
        tr = te.run_graph(te.lower(MatMulTask(m=64, n=64, k=64)))
        jr = je.run_graph(je.lower(JTask(m=64, n=64, k=64)))
        assert tr.output is None and jr.output is None
        assert tr.cycles == jr.cycles > 0
