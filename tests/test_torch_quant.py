"""The port's int8 path against the reference's, on the same inputs.

K3's plain version is bit-identical to the reference's
``quantize_rowwise_ref`` (q and scale), with zero rows, exact .5 ties
and bf16/fp16 input; against the Pallas kernel (interpret mode) q is
identical and the scale within the reference test's 1e-6, because XLA
computes that kernel's ``absmax / 127`` as a multiplication by the
reciprocal.  ``quantize_colwise_ref`` is bit-identical;
``smoothquant_migrate`` agrees within a few ulp (XLA's ``pow`` is not
correctly rounded).  ``W8A8Linear`` and ``quantize_mlp``: identical int8
weights, outputs within 1e-5 in fp32 on the reference's own layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.quant.ops import quantize_rowwise as j_pallas  # noqa: E402
from repro.kernels.quant.ref import (                    # noqa: E402
    quantize_colwise_ref as j_colwise, quantize_rowwise_ref as j_rowwise,
    smoothquant_migrate as j_migrate)
from repro.serving.quantized import (                    # noqa: E402
    W8A8Linear as JW8A8, quantize_mlp as j_quantize_mlp)
from repro_torch.kernels.quant import ops as q_ops       # noqa: E402
from repro_torch.kernels.quant import quant as q_kernel  # noqa: E402
from repro_torch.kernels.quant.ref import (               # noqa: E402
    quantize_colwise_ref, smoothquant_migrate)
from repro_torch.models.convert import to_torch, w8a8_from_jax  # noqa: E402
from repro_torch.serving.quantized import (               # noqa: E402
    W8A8Linear, quantize_mlp)


def _rng(seed):
    return np.random.default_rng(seed)


def _inputs(kind, dtype):
    """(M, K) float32 rows as numpy, cast to ``dtype`` by both sides."""
    rng = _rng(len(kind))
    if kind == "ties":
        # absmax 127 gives scale 1, so x / scale is x: every n + .5 and
        # -(n + .5) is an exact tie, rounded to even.
        x = rng.integers(-254, 255, (24, 96)) / 2.0
        x[:, 0] = 127.0
    else:
        x = rng.standard_normal((37, 200)) * 3.0
    x[3] = 0.0                                           # a zero row
    return x.astype(np.float32)


CASES = [("random", "float32"), ("ties", "float32"), ("random", "bfloat16"),
         ("ties", "bfloat16"), ("random", "float16")]


@pytest.mark.parametrize("kind,dtype", CASES)
def test_quantize_rowwise_plain_bit_identical_to_ref(kind, dtype):
    x = jnp.asarray(_inputs(kind, dtype), dtype)
    q_ref, s_ref = j_rowwise(x)
    q, s = q_ops.quantize_rowwise(to_torch(np.asarray(x)))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    assert (q.numpy()[3] == 0).all() and s[3].item() == 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rowwise_plain_matches_pallas(dtype):
    x = jnp.asarray(_inputs("random", dtype), dtype)
    q_ref, s_ref = j_pallas(x, block_m=16)
    q, s = q_kernel.quantize_rowwise_plain(to_torch(np.asarray(x)))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-6)


def test_quantize_colwise_bit_identical():
    w = _inputs("random", "float32").T.copy()
    w[:, 5] = 0.0                                         # a zero column
    q_ref, s_ref = j_colwise(jnp.asarray(w))
    q, s = quantize_colwise_ref(torch.from_numpy(w))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))


@pytest.mark.parametrize("alpha", [0.5, 0.3, 0.8])
def test_smoothquant_migrate_within_a_few_ulp(alpha):
    rng = _rng(11)
    a = (np.abs(rng.standard_normal(4000)) * 5).astype(np.float32)
    b = np.abs(rng.standard_normal(4000)).astype(np.float32)
    a[:3] = 0.0                                           # clamped to 1e-5
    ref = np.asarray(j_migrate(jnp.asarray(a), jnp.asarray(b), alpha))
    out = smoothquant_migrate(torch.from_numpy(a), torch.from_numpy(b),
                              alpha).numpy()
    np.testing.assert_allclose(out, ref, rtol=5e-7, atol=0)


def test_quantize_rowwise_raises_instead_of_falling_back(monkeypatch):
    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    def fail(x):
        raise RuntimeError("quantize_rowwise kernel launch failed: CUDA "
                           "error 700")
    monkeypatch.setattr(q_ops, "quantize_rowwise_cuda", fail)
    x = torch.Tensor._make_subclass(FakeCuda, torch.ones(4, 8))
    before = q_ops.quantize_rowwise.launches
    with pytest.raises(RuntimeError, match="error 700"):
        q_ops.quantize_rowwise(x)
    assert q_ops.quantize_rowwise.launches == before
    # A launch that returns a CUDA error raises too.
    monkeypatch.setattr(q_kernel, "_launcher", lambda: lambda *a: 700)

    class _Stream:
        cuda_stream = None
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        q_kernel.quantize_rowwise_cuda(torch.ones(4, 8))
    with pytest.raises(ValueError):
        q_ops.quantize_rowwise(torch.ones(2, 4, 8))


# ---------------------------------------------------------------------------
# The W8A8 layer.
# ---------------------------------------------------------------------------

def _layer_inputs(smooth, bias):
    rng = _rng(3)
    x = rng.standard_normal((32, 128)).astype(np.float32)
    x[:, :4] *= 60.0                                       # outlier channels
    w = rng.standard_normal((128, 96)).astype(np.float32)
    b = rng.standard_normal(96).astype(np.float32) if bias else None
    act = np.abs(x).max(0) if smooth else None
    return x, w, b, act


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("smooth", [False, True])
def test_w8a8_from_float_matches_jax(smooth, bias):
    x, w, b, act = _layer_inputs(smooth, bias)
    jl = JW8A8.from_float(jnp.asarray(w), None if b is None else
                          jnp.asarray(b),
                          None if act is None else jnp.asarray(act))
    tl = W8A8Linear.from_float(torch.from_numpy(w), None if b is None else
                               torch.from_numpy(b),
                               None if act is None else torch.from_numpy(act))
    np.testing.assert_array_equal(tl.w_q.numpy(), np.asarray(jl.w_q))
    if smooth:      # the migration scale is a few ulp off (XLA's pow)
        np.testing.assert_allclose(tl.smooth.numpy(), np.asarray(jl.smooth),
                                   rtol=5e-7)
        np.testing.assert_allclose(tl.w_scale.numpy(),
                                   np.asarray(jl.w_scale), rtol=5e-7)
    else:
        assert tl.smooth is None
        np.testing.assert_array_equal(tl.w_scale.numpy(),
                                      np.asarray(jl.w_scale))


@pytest.mark.parametrize("route", ["kernel", "torch"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("smooth", [False, True])
def test_w8a8_call_matches_jax(smooth, bias, route):
    x, w, b, act = _layer_inputs(smooth, bias)
    jl = JW8A8.from_float(jnp.asarray(w), None if b is None else
                          jnp.asarray(b),
                          None if act is None else jnp.asarray(act))
    tl = w8a8_from_jax(jl)
    ref = jl(jnp.asarray(x), activation="gelu", out_dtype=jnp.float32)
    out = tl(torch.from_numpy(x), activation="gelu", out_dtype=torch.float32,
             backend=route)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    bf16 = tl(torch.from_numpy(x), backend=route)
    assert bf16.dtype == torch.bfloat16


def test_quantize_mlp_matches_jax():
    d, ff = 64, 128
    rng = _rng(7)
    x = rng.standard_normal((16, d)).astype(np.float32)
    wi = (rng.standard_normal((d, 2 * ff)) / np.sqrt(d)).astype(np.float32)
    wo = (rng.standard_normal((ff, d)) / np.sqrt(ff)).astype(np.float32)
    j_in, j_out = j_quantize_mlp(jnp.asarray(wi), jnp.asarray(wo),
                                 jnp.asarray(x))
    t_in, t_out = quantize_mlp(torch.from_numpy(wi), torch.from_numpy(wo),
                               torch.from_numpy(x))
    for j, t in ((j_in, t_in), (j_out, t_out)):
        np.testing.assert_array_equal(t.w_q.numpy(), np.asarray(j.w_q))
        np.testing.assert_allclose(t.w_scale.numpy(), np.asarray(j.w_scale),
                                   rtol=5e-7)

    jh = j_in(jnp.asarray(x), out_dtype=jnp.float32)
    jy = j_out(jax.nn.silu(jh[:, :ff]) * jh[:, ff:], out_dtype=jnp.float32)
    th = t_in(torch.from_numpy(x), out_dtype=torch.float32)
    ty = t_out(torch.nn.functional.silu(th[:, :ff]) * th[:, ff:],
               out_dtype=torch.float32)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    # and the whole W8A8 MLP tracks the float one, as the reference's test
    h = x @ wi
    ref = (h[:, :ff] / (1 + np.exp(-h[:, :ff])) * h[:, ff:]) @ wo
    assert np.abs(ty.numpy() - ref).max() / np.abs(ref).max() < 0.05
