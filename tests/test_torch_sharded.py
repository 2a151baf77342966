"""The port's ``sharded`` backend against the reference's.

The cases of ``tests/test_cluster.py``'s ``TestShardedParity`` and
``test_sharded_executes_schedule_bit_exact``, and of
``tests/test_scheduler.py``'s ``TestPolicyExecutionParity``: the same
numpy operands (drawn from a seed) and the same schedules go through the
reference's ``jax`` and ``sharded`` backends and the port's ``sharded``
backend, in one process here, where the spans run as a loop (the
multi-rank path runs in ``tests/test_torch_distributed.py`` and on the
card).  int8 outputs must be equal bit for bit, fp32 epilogue graphs
within 1e-6 (the reference test's tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import backend as j_backend                      # noqa: E402
from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.core.fusion import Epilogue as JEpilogue         # noqa: E402
from repro.core.task import MatMulTask as JTask             # noqa: E402
from repro.distributed.sharding import (                    # noqa: E402
    shard_map_gemm as j_shard_map_gemm)
from repro.serving.engine import ServingEngine as JEngine   # noqa: E402
from repro_torch import backend                             # noqa: E402
from repro_torch.configs.registry import get_config         # noqa: E402
from repro_torch.core.fusion import Epilogue, cute_matmul   # noqa: E402
from repro_torch.core.task import MatMulTask                # noqa: E402
from repro_torch.distributed.sharding import shard_map_gemm  # noqa: E402
from repro_torch.models.convert import to_torch             # noqa: E402
from repro_torch.serving.engine import ServingEngine        # noqa: E402
from repro_torch.sim.lower import build_gemm_graph          # noqa: E402
from repro_torch.sim.partition import partition_graph       # noqa: E402


def _int8_pair(seed, m, n, k):
    rng = np.random.default_rng(seed)
    return (rng.integers(-8, 8, (m, k)).astype(np.int8),
            rng.integers(-8, 8, (k, n)).astype(np.int8))


def _j_ops(a, b):
    return j_backend.MatMulOperands(a=jnp.asarray(a), b=jnp.asarray(b))


def _ops(a, b):
    return backend.MatMulOperands(a=to_torch(a), b=to_torch(b))


class TestShardedParity:
    def test_registered(self):
        sh = backend.get("sharded", units=2)
        assert sh.executes and sh.supports_units and not sh.models_time
        assert backend.matmul_backend_string("sharded") == "kernel"

    @pytest.mark.parametrize("strategy", ["row-panel", "output-tile",
                                          "layer-pipeline"])
    @pytest.mark.parametrize("units", [2, 4])
    def test_int8_bit_exact(self, strategy, units):
        a, b = _int8_pair(1, 128, 192, 256)
        jt, tt = JTask(m=128, n=192, k=256), MatMulTask(m=128, n=192, k=256)
        jsh = j_backend.get("sharded", units=units, strategy=strategy)
        ref = np.asarray(jsh.wait(jsh.dispatch(jt, _j_ops(a, b))).output)
        sh = backend.get("sharded", units=units, strategy=strategy)
        out = sh.wait(sh.dispatch(tt, _ops(a, b))).output
        assert out.dtype == torch.int32 and ref.dtype == np.int32
        assert np.array_equal(out.numpy(), ref)

    def test_epilogue_graph_matches_reference(self):
        a, b = _int8_pair(4, 128, 256, 128)
        jx = j_backend.get("jax", granularity="panel")
        jg = jx.lower(JTask(m=128, n=256, k=128), epilogue=JEpilogue(
            activation="silu", glu=True, out_dtype=jnp.float32))
        ref = np.asarray(j_backend.get("sharded", units=2,
                                       granularity="panel").run_graph(
            jg, _j_ops(a, b)).output)
        ep = Epilogue(activation="silu", glu=True, out_dtype=torch.float32)
        sh = backend.get("sharded", units=2, granularity="panel")
        graph = sh.lower(MatMulTask(m=128, n=256, k=128), epilogue=ep)
        out = sh.run_graph(graph, _ops(a, b)).output
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
        direct = cute_matmul(to_torch(a), to_torch(b), epilogue=ep,
                             backend="torch")
        np.testing.assert_allclose(out.numpy(), direct.numpy(), rtol=1e-6,
                                   atol=1e-6)

    def test_requires_operands(self):
        with pytest.raises(ValueError):
            backend.get("sharded", units=2).dispatch(
                MatMulTask(m=8, n=8, k=8))

    def test_mismatched_partition_rejected(self):
        g, _ = build_gemm_graph(MatMulTask(m=128, n=64, k=64), 64, 64)
        part = partition_graph(g, 4, "row-panel")
        with pytest.raises(ValueError, match="partitioned for 4"):
            backend.get("sharded", units=2).run_graph(part)

    def test_unbalanced_spans_execute_partition_layout(self):
        """m=128 over 4 units leaves two units idle (2 panels): execution
        walks the partition's own spans, bit-exact, as the reference."""
        g, _ = build_gemm_graph(MatMulTask(m=128, n=64, k=64), 64, 64)
        part = partition_graph(g, 4, "row-panel")
        spans = part.spans["gemm"]
        assert not part.balanced("gemm") and None in spans
        a, b = _int8_pair(3, 128, 64, 64)
        ref = np.asarray(j_shard_map_gemm(jnp.asarray(a), jnp.asarray(b), 4,
                                          dim="m", bounds=spans))
        out = backend.get("sharded", units=4).run_graph(
            part, _ops(a, b)).output
        assert np.array_equal(out.numpy(), ref)
        acc = shard_map_gemm(to_torch(a), to_torch(b), 4, dim="m",
                             bounds=spans)
        assert np.array_equal(acc.numpy(), ref)


def _engines(n_requests, max_batch, base_len=4, stride=1):
    """The reference's and the port's planning engines on the same
    prompts (reduced yi-6b; the reference tests' lengths)."""
    je = JEngine(j_get_config("yi-6b", reduced=True), None,
                 max_batch=max_batch, cache_len=64)
    te = ServingEngine(get_config("yi-6b", reduced=True), None,
                       max_batch=max_batch, cache_len=64)
    for i in range(n_requests):
        n = base_len + stride * i
        je.submit(jnp.zeros(n, jnp.int32))
        te.submit(torch.zeros(n, dtype=torch.int32))
    return je, te


def _run_both(je, te, seed, plan_kw, sharded_kw):
    js, ts = je.plan(**plan_kw), te.plan(**plan_kw)
    jops = js.example_operands(jax.random.PRNGKey(seed))
    tops = {k: tuple(to_torch(np.asarray(x)) for x in v)
            for k, v in jops.items()}
    jsh = j_backend.get("sharded", **sharded_kw)
    ref = jsh.run_graph(jsh.lower(js.layers), jops).outputs
    sh = backend.get("sharded", **sharded_kw)
    out = sh.run_graph(sh.lower(ts.layers), tops).outputs
    assert set(out) == set(ref) == set(tops)
    for label, (a, b) in tops.items():
        assert out[label].dtype == torch.int32, label
        assert np.array_equal(out[label].numpy(), np.asarray(ref[label])), \
            label
        assert torch.equal(out[label], cute_matmul(a, b, backend="torch"))


class TestScheduleExecution:
    def test_sharded_executes_schedule_bit_exact(self):
        je, te = _engines(3, 2)
        _run_both(je, te, 7, dict(max_new_tokens=4, units=2),
                  dict(units=2))

    @pytest.mark.parametrize("policy", ["full-prefill", "chunked-prefill",
                                        "decode-priority"])
    def test_policy_schedules_bit_exact(self, policy):
        je, te = _engines(3, 2)
        kw = {} if policy == "full-prefill" else {"chunk_tokens": 6}
        _run_both(je, te, 7, dict(max_new_tokens=2, units=2, policy=policy,
                                  **kw),
                  dict(units=2, strategy="output-tile"))

    def test_affinity_partition_executes_bit_exact(self):
        je, te = _engines(3, 2)
        plan_kw = dict(max_new_tokens=2, units=2, policy="decode-priority",
                       chunk_tokens=6)
        sched = te.plan(**plan_kw)
        assert sched.affinity
        _run_both(je, te, 8, plan_kw,
                  dict(units=2, strategy="unit-affinity",
                       affinity=dict(sched.affinity)))
