"""The port's asyncMatMul engine: Status transitions of the paper's
interface register, and Listing 1's tiled pipeline against the
reference's, int8 bit-exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import engine as jeng                    # noqa: E402
from repro_torch.core import (AsyncMatmulEngine, DataType,  # noqa: E402
                              Epilogue, MatMulTask, Status,
                              pipelined_fused_matmul, tile_tasks)
from repro.core.task import MatMulTask as JTask          # noqa: E402
from repro.core.task import tile_tasks as j_tile_tasks   # noqa: E402


@pytest.mark.parametrize("route", ["kernel", "torch"])
def test_status_idle_running_done(route):
    eng = AsyncMatmulEngine(backend=route)
    task = MatMulTask(m=8, n=4, k=16, data_type=DataType.FP32)
    assert task.status is Status.IDLE
    h = eng.dispatch(task, torch.ones(8, 16), torch.ones(16, 4))
    assert task.status is Status.RUNNING and not eng.check(h)
    out = eng.wait(h)
    assert task.status is Status.DONE and eng.check(h) and h.done()
    assert torch.equal(out, torch.full((8, 4), 16.0))


def test_handle_reads_status_register_and_drain():
    eng = AsyncMatmulEngine()
    task = MatMulTask(m=4, n=4, k=8, data_type=DataType.FP32)
    h = eng.dispatch(task, torch.ones(4, 8), torch.ones(8, 4))
    task.status = Status.DONE            # hardware flips the register
    assert h.done() and eng.check(h)
    task.status = Status.RUNNING
    assert not h.done()
    eng.dispatch(MatMulTask(m=4, n=4, k=8), torch.ones(4, 8),
                 torch.ones(8, 4))
    assert len(eng.drain()) == 2 and h.done()
    with pytest.raises(ValueError):
        eng.dispatch(MatMulTask(m=9, n=4, k=8), torch.ones(4, 8),
                     torch.ones(8, 4))


def test_int8_dispatch_epilogue_exact():
    rng = np.random.default_rng(0)
    a = rng.integers(-127, 128, (32, 64)).astype(np.int8)
    b = rng.integers(-127, 128, (64, 48)).astype(np.int8)
    eng = AsyncMatmulEngine()
    h = eng.dispatch(MatMulTask(m=32, n=48, k=64), torch.from_numpy(a),
                     torch.from_numpy(b),
                     epilogue=Epilogue(out_dtype=torch.int32))
    ref = jeng.AsyncMatmulEngine().dispatch(
        JTask(m=32, n=48, k=64), jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(eng.wait(h).numpy(),
                                  np.asarray(ref.force()))


def test_tile_tasks_match_reference():
    ours = tile_tasks(MatMulTask(m=100, n=70, k=8), 32, 32)
    ref = j_tile_tasks(JTask(m=100, n=70, k=8), 32, 32)
    assert ([(t.m, t.n, t.base_a, t.base_c) for t in ours]
            == [(t.m, t.n, t.base_a, t.base_c) for t in ref])


@pytest.mark.parametrize("tile_m", [16, 32, 64])
def test_pipelined_int8_bit_exact_vs_jax(tile_m):
    rng = np.random.default_rng(tile_m)
    a = rng.integers(-127, 128, (64, 96)).astype(np.int8)
    b = rng.integers(-127, 128, (96, 40)).astype(np.int8)
    ours = pipelined_fused_matmul(torch.from_numpy(a), torch.from_numpy(b),
                                  lambda t: torch.relu(t) // 3,
                                  tile_m=tile_m)
    ref = jeng.pipelined_fused_matmul(jnp.asarray(a), jnp.asarray(b),
                                      lambda t: jax.nn.relu(t) // 3,
                                      tile_m=tile_m)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_pipelined_fp32_and_tile_must_divide():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((128, 64)).astype(np.float32)
    b = rng.standard_normal((64, 96)).astype(np.float32)
    ours = pipelined_fused_matmul(torch.from_numpy(a), torch.from_numpy(b),
                                  torch.relu, tile_m=32)
    ref = jeng.pipelined_fused_matmul(jnp.asarray(a), jnp.asarray(b),
                                      jax.nn.relu, tile_m=32)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError):
        pipelined_fused_matmul(torch.ones(10, 4), torch.ones(4, 4),
                               torch.relu, tile_m=3)
