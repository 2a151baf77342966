"""The port's examples against the reference's, on the CPU: the pricing
and simulation examples (``sim_timeline``, ``cluster_scaling``,
``serving_policies``) and ``quickstart``.

Each port-side example (``examples/<name>_torch.py``) runs with
``--device cpu``, where every kernel wrapper runs its plain version.
Every simulated cycle count, utilisation and pricing metric is held
``==`` to the reference's (the printed lines, and the numbers at full
precision); the int8 products bit for bit on the reference's own
operands (drawn from its ``jax.random`` keys and carried across through
numpy); ``quickstart``'s bf16 products within 3e-2 of max |out|, the
tolerance of ``tests/test_matmul_kernel.py``.
"""

import functools
import importlib.util
import json
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import backend as j_backend                   # noqa: E402
from repro.core import fusion as j_fusion                # noqa: E402
from repro.core.task import MatMulTask as JTask          # noqa: E402
from repro_torch.models.convert import to_torch          # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

#: quickstart's bf16 products: the tolerance of tests/test_matmul_kernel.py
TOL_BF16 = 3e-2
#: fp32 elementwise work done by XLA and by torch: the SiLU (and the tanh
#: GELU) round differently in the last bit
TOL_FP32_ULPS = 1e-6


@functools.cache
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _example(name):
    """``examples/<name>.py`` as a module (the reference's or the port's),
    by ``chip_smoke.py``'s loader."""
    return _chip_smoke().example_module(name)


def _lines(run, capsys):
    capsys.readouterr()
    out = run()
    return out, capsys.readouterr().out.splitlines()


def _reference_main(name, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    return _lines(_example(name).main, capsys)[1]


def _jax_int8(shape_a, shape_b):
    """The reference examples' operands: int8 in [-8, 8) from the two
    halves of ``PRNGKey(0)``."""
    ka, kb = jax.random.split(jax.random.PRNGKey(0))
    return (jax.random.randint(ka, shape_a, -8, 8, jnp.int8),
            jax.random.randint(kb, shape_b, -8, 8, jnp.int8))


# ---------------------------------------------------------------------------
# sim_timeline
# ---------------------------------------------------------------------------

class TestSimTimeline:
    def test_prints_and_trace_equal_reference(self, tmp_path, capsys,
                                              monkeypatch):
        """Every printed line but the executed graph's (the reference's
        ``jax`` backend is the port's ``kernel``) and the trace path; the
        Chrome trace itself equal."""
        ref = _reference_main("sim_timeline",
                              ["--out", str(tmp_path / "ref.json")],
                              capsys, monkeypatch)
        port_ex = _example("sim_timeline_torch")
        _, port = _lines(lambda: port_ex.main(
            ["--out", str(tmp_path / "port.json"), "--device", "cpu"]),
            capsys)
        assert len(port) == len(ref)
        for r, p in zip(ref, port):
            if r.startswith("jax backend on the same graph"):
                assert p == ("kernel backend on the same graph: out "
                             "(256, 256), max |Δ| vs cute_matmul = 0.00e+00")
            elif r.startswith("wrote"):
                assert p == r.replace("ref.json", "port.json")
            else:
                assert p == r
        assert json.loads((tmp_path / "port.json").read_text()) == \
            json.loads((tmp_path / "ref.json").read_text())

    def test_simulated_numbers_equal_reference(self):
        """Cycles and utilisations of the four platforms, the fused and
        unfused workloads and the analytical form, at full precision."""
        from repro.core.hardware import PLATFORMS as J_PLATFORMS
        from repro.core.simulator import LayerTrace as JLayer
        from repro.sim.lower import epilogue_vector_ops as j_vec_ops
        ex = _example("sim_timeline_torch")
        task = ex.MatMulTask(m=ex.M, n=ex.N, k=ex.K)
        jtask = JTask(m=ex.M, n=ex.N, k=ex.K)
        jep = j_fusion.Epilogue(activation="silu", glu=True,
                                out_dtype=jnp.float32)
        ours = ex.simulate(task, ex.EPILOGUE)
        assert list(ours) == list(J_PLATFORMS)
        for name, platform in J_PLATFORMS.items():
            eng = j_backend.get("desim", platform=platform,
                                granularity="panel")
            r = eng.wait(eng.dispatch(jtask, epilogue=jep))
            assert ours[name].cycles == r.cycles
            assert ours[name].detail["utilizations"] == \
                r.detail["utilizations"]
        desim = j_backend.get("desim", granularity="panel")
        layer = JLayer("gate_up", (jtask,),
                       vector_ops=j_vec_ops(jep, ex.M, ex.N),
                       intermediate_bytes=4.0 * ex.M * ex.N)
        fused, unfused = ex.overlap(task, ex.EPILOGUE)
        assert fused == desim.run_workload([layer], fused=True)
        assert unfused == desim.run_workload([layer], fused=False)
        graph, jgraph = ex.lower(task, ex.EPILOGUE), desim.lower(
            jtask, epilogue=jep)
        assert ex.backend.get("analytical", granularity="panel").run_graph(
            graph).cycles == j_backend.get(
                "analytical", granularity="panel").run_graph(jgraph).cycles

    def test_graph_on_reference_operands(self):
        """The reference's operands through the port's graph: every int8
        tile's accumulator bit for bit (the graph lowered without its
        epilogue), the SiLU-GLU output equal to one ``cute_matmul`` bit
        for bit and within TOL_FP32_ULPS of max |out| of the reference's
        graph output."""
        ex = _example("sim_timeline_torch")
        a, b = _jax_int8((ex.M, ex.K), (ex.K, ex.N))
        ta, tb = to_torch(a), to_torch(b)
        task = ex.MatMulTask(m=ex.M, n=ex.N, k=ex.K)
        jtask = JTask(m=ex.M, n=ex.N, k=ex.K)
        jep = j_fusion.Epilogue(activation="silu", glu=True,
                                out_dtype=jnp.float32)
        desim = j_backend.get("desim", granularity="panel")
        ops = j_backend.MatMulOperands(a=a, b=b)

        out, direct = ex.execute(ex.lower(task, ex.EPILOGUE), ta, tb,
                                 ex.EPILOGUE)
        assert out.shape == (ex.M, ex.N // 2) and out.dtype == torch.float32
        assert torch.equal(out, direct)
        ref = np.asarray(j_backend.get("jax").run_graph(
            desim.lower(jtask, epilogue=jep), ops).output)
        scale = np.abs(ref).max()
        assert np.abs(out.numpy() - ref).max() <= TOL_FP32_ULPS * scale

        acc, _ = ex.execute(ex.lower(task, ex.Epilogue()), ta, tb,
                            ex.Epilogue())
        j_acc = np.asarray(j_backend.get("jax").run_graph(
            desim.lower(jtask), ops).output)
        assert acc.dtype == torch.int32
        np.testing.assert_array_equal(acc.numpy(), j_acc)


# ---------------------------------------------------------------------------
# cluster_scaling
# ---------------------------------------------------------------------------

class TestClusterScaling:
    def test_prints_and_trace_equal_reference(self, tmp_path, capsys,
                                              monkeypatch):
        """``--units 4``: every line equal (the reference's ``jax`` is the
        port's ``kernel``, the trace path aside), the trace equal."""
        ref = _reference_main("cluster_scaling",
                              ["--units", "4", "--out",
                               str(tmp_path / "ref.json")],
                              capsys, monkeypatch)
        ex = _example("cluster_scaling_torch")
        got, port = _lines(lambda: ex.main(
            ["--units", "4", "--out", str(tmp_path / "port.json"),
             "--device", "cpu"]), capsys)
        assert got["sweep"] == [1, 2, 4]
        assert all(got["exact"].values())
        assert port == [ln.replace("sharded==jax", "sharded==kernel")
                        .replace("ref.json", "port.json") for ln in ref]
        assert json.loads((tmp_path / "port.json").read_text()) == \
            json.loads((tmp_path / "ref.json").read_text())

    @pytest.mark.parametrize("n", [1, 2, 4])
    @pytest.mark.parametrize("fixed", [False, True])
    def test_weak_scaling_equals_reference(self, n, fixed):
        """The sweep's every figure at full precision, pooled and fixed
        loader bandwidth."""
        ref_ex, ex = _example("cluster_scaling"), _example(
            "cluster_scaling_torch")
        bw = ex.PLATFORM_2TOPS.bandwidth if fixed else None
        (jp, jr), (tp, tr) = ref_ex.run(n, total_bandwidth=bw), ex.run(
            n, total_bandwidth=bw)
        assert tp.n_transfers == jp.n_transfers
        assert (tr.cycles, tr.aggregate_matrix_utilization,
                tr.loader_utilization, tr.loader_contention()) == \
            (jr.cycles, jr.aggregate_matrix_utilization,
             jr.loader_utilization, jr.loader_contention())

    def test_strategies_on_reference_operands(self):
        """The reference's operands: the kernel route's int32 and each
        strategy's ``sharded`` result bit for bit the reference's, and
        each strategy's priced cycles, utilisation and transfers ``==``."""
        ex = _example("cluster_scaling_torch")
        task = ex.STRATEGY_TASK
        a, b = _jax_int8((task.m, task.k), (task.k, task.n))
        ref_out, by_strategy = ex.strategies(to_torch(a), to_torch(b))
        jtask = JTask(m=task.m, n=task.n, k=task.k)
        ops = j_backend.MatMulOperands(a=a, b=b)
        jax_out = np.asarray(j_backend.get("jax").wait(
            j_backend.get("jax").dispatch(jtask, ops)).output)
        assert ref_out.dtype == torch.int32
        np.testing.assert_array_equal(ref_out.numpy(), jax_out)
        assert list(by_strategy) == ["row-panel", "output-tile",
                                     "layer-pipeline"]
        for strategy, (r, out) in by_strategy.items():
            eng = j_backend.get("desim-cluster", units=4, strategy=strategy)
            jr = eng.wait(eng.dispatch(jtask))
            assert (r.cycles, r.utilization) == (jr.cycles, jr.utilization)
            assert r.detail["partition"] == jr.detail["partition"]
            sh = j_backend.get("sharded", units=4, strategy=strategy)
            j_sh = np.asarray(sh.wait(sh.dispatch(jtask, ops)).output)
            np.testing.assert_array_equal(out.numpy(), j_sh)


# ---------------------------------------------------------------------------
# serving_policies
# ---------------------------------------------------------------------------

class TestServingPolicies:
    def test_prints_and_traces_equal_reference(self, tmp_path, capsys,
                                               monkeypatch):
        """The whole printout equal, and both traces it writes into the
        working directory."""
        (tmp_path / "ref").mkdir()
        (tmp_path / "port").mkdir()
        monkeypatch.chdir(tmp_path / "ref")
        ref = _reference_main("serving_policies", [], capsys, monkeypatch)
        monkeypatch.chdir(tmp_path / "port")
        _, port = _lines(lambda: _example("serving_policies_torch").main(
            ["--device", "cpu"]), capsys)
        assert port == ref
        for name in ("serving_policy_trace.json",
                     "serving_overlap_trace.json"):
            assert json.loads((tmp_path / "port" / name).read_text()) == \
                json.loads((tmp_path / "ref" / name).read_text())

    @pytest.mark.parametrize("gap", [0.0, 30000.0])
    def test_pricing_equals_reference(self, gap):
        """Every policy's metrics on 1 and 2 units, the auto-plan's
        report and the heterogeneous topology's cost, at full precision,
        on the reference's own prompts."""
        from repro.configs.registry import get_config as j_get_config
        from repro.serving.scheduler import schedule_metrics as j_metrics
        ref_ex, ex = _example("serving_policies"), _example(
            "serving_policies_torch")
        jcfg = j_get_config("yi-6b", reduced=True)
        cfg = ex.get_config("yi-6b", reduced=True)
        jeng = ref_ex.queue(jcfg, arrival_gap=gap)
        key, prompts = jax.random.PRNGKey(0), []
        for i in range(6):
            key, sub = jax.random.split(key)
            prompts.append(to_torch(jax.random.randint(
                sub, (48 + 24 * i,), 0, jcfg.vocab_size)))
        eng = ex.queue(cfg, arrival_gap=gap, prompts=prompts)
        for units in (1, 2):
            for pol in ex.available_policies():
                m = ex.schedule_metrics(
                    eng.plan(max_new_tokens=16, units=units, policy=pol),
                    cfg.n_layers, "analytical")
                assert m == j_metrics(
                    jeng.plan(max_new_tokens=16, units=units, policy=pol),
                    jcfg.n_layers, "analytical")
        _, report = eng.autoplan(max_new_tokens=16, units=2)
        _, j_report = jeng.autoplan(max_new_tokens=16, units=2)
        assert report["chosen"] == j_report["chosen"]
        for ov in ("chained", "relaxed"):
            _, res = eng.evaluate_schedule(
                "desim-cluster", max_new_tokens=16, units=2,
                policy="decode-priority", overlap=ov, workload=False)
            _, j_res = jeng.evaluate_schedule(
                "desim-cluster", max_new_tokens=16, units=2,
                policy="decode-priority", overlap=ov, workload=False)
            assert (res.cycles, res.utilization) == (j_res.cycles,
                                                     j_res.utilization)


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

class TestQuickstart:
    def test_prints_equal_reference(self, capsys, monkeypatch):
        """The task, the dispatch, the case study and the simulated GEMM
        lines equal; the products' lines in their own form (the port's
        kernel is K1 on a card, its Eq. 2 tile the H100's)."""
        ref = _reference_main("quickstart", [], capsys, monkeypatch)
        got, port = _lines(lambda: _example("quickstart_torch").main(
            ["--device", "cpu"]), capsys)
        assert len(port) == len(ref)
        same = [i for i, ln in enumerate(ref) if not ln.startswith((
            "result:", "pipelined", "pallas", "TPU tile"))]
        assert len(same) == len(ref) - 4
        assert [port[i] for i in same] == [ref[i] for i in same]
        assert port[2] == "result: (256, 1024) torch.bfloat16"
        assert port[4] == "kernel max |Δ|: 0.0"
        tc = got["tile"]
        assert re.fullmatch(
            r"H100 tile from the same constraint model: \(\d+, \d+, 64\), "
            r"shared memory \d+ B \(\d+ KiB\), ideal util [\d.]+%", port[-1])
        assert tc.smem_bytes <= 232448

    def test_simulated_gemm_equals_reference(self):
        from repro.core.config import CASE_STUDY as J_CASE
        from repro.core.hardware import SHUTTLE as J_SHUTTLE
        from repro.core.simulator import simulate_gemm as j_simulate
        ex = _example("quickstart_torch")
        r = ex.simulate_gemm(ex.CASE_STUDY,
                             ex.MatMulTask(m=512, n=512, k=4096), ex.SHUTTLE)
        jr = j_simulate(J_CASE, JTask(m=512, n=512, k=4096), J_SHUTTLE)
        assert r.utilization == jr.utilization
        assert r.breakdown == jr.breakdown
        assert ex.CASE_STUDY.describe() == J_CASE.describe()

    def test_products_on_reference_operands(self):
        """The reference's bf16 operands: the engine's result and the
        kernel route's within TOL_BF16 of max |out| of each other and of
        the reference engine's; the pipelined fp32 product within
        TOL_FP32_ULPS of the reference's."""
        from repro.core import AsyncMatmulEngine as JEngine
        from repro.core import BiasType as JBias
        from repro.core import DataType as JDType
        from repro.core import pipelined_fused_matmul as j_pipelined
        ex = _example("quickstart_torch")
        a = jax.random.normal(jax.random.PRNGKey(0), (256, 512),
                              jnp.bfloat16)
        w = jax.random.normal(jax.random.PRNGKey(1), (512, 1024),
                              jnp.bfloat16)
        bias = jnp.zeros((1024,), jnp.float32)
        jtask = JTask(m=256, n=1024, k=512, data_type=JDType.BF16,
                      bias_type=JBias.ROW)
        jeng = JEngine()
        j_out = np.asarray(jeng.wait(jeng.dispatch(
            jtask, a, w,
            epilogue=j_fusion.Epilogue(bias_type=JBias.ROW,
                                       activation="gelu"),
            operands=j_fusion.EpilogueOperands(bias=bias)))
            .astype(jnp.float32))
        ta, tw, tbias = to_torch(a), to_torch(w), to_torch(bias)
        task = ex.MatMulTask(m=256, n=1024, k=512,
                             data_type=ex.DataType.BF16,
                             bias_type=ex.BiasType.ROW)
        done, out = ex.dispatch(ta, tw, tbias, task)
        assert done is False                 # staged on the CPU
        assert out.dtype == torch.bfloat16 and out.shape == (256, 1024)
        scale = float(out.float().abs().max())
        kern = ex.kernel_route(ta, tw, tbias).float()
        assert float((kern - out.float()).abs().max()) <= TOL_BF16 * scale
        assert np.abs(out.float().numpy() - j_out).max() <= \
            TOL_BF16 * np.abs(j_out).max()
        pipe = ex.pipelined(ta, tw)
        j_pipe = np.asarray(j_pipelined(a.astype(jnp.float32),
                                        w.astype(jnp.float32),
                                        jax.nn.gelu, tile_m=64))
        assert np.abs(pipe.numpy() - j_pipe).max() <= \
            TOL_FP32_ULPS * np.abs(j_pipe).max()


@pytest.mark.parametrize("name", ["sim_timeline_torch",
                                  "cluster_scaling_torch",
                                  "serving_policies_torch",
                                  "quickstart_torch",
                                  "serve_batched_torch", "train_lm_torch"])
def test_examples_need_a_card_or_device_cpu(name, monkeypatch):
    """Without a card and without ``--device`` each example stops before
    any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        _example(name).main([])
