"""The port's ``cute_matmul`` on the CPU against the reference's: the JAX
``"xla"`` route and the Pallas fused kernel in interpret mode.  Both port
routes run: ``"torch"`` and ``"kernel"`` (the kernel's plain version, as
the tensors lie on the CPU).  Tolerances are those of
tests/test_matmul_kernel.py: int8 exact, bf16/fp16 3e-2, fp32 1e-5,
relative to max |ref|."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import fusion as jf                      # noqa: E402
from repro.core.task import BiasType as JBias            # noqa: E402
from repro.kernels.matmul.ops import fused_matmul as j_fused  # noqa: E402
from repro_torch import backend                          # noqa: E402
from repro_torch.core import fusion as tf                # noqa: E402
from repro_torch.core.task import BiasType as TBias      # noqa: E402
from repro_torch.kernels.matmul.ops import fused_matmul  # noqa: E402
from repro_torch.kernels.matmul.ref import fused_matmul_ref  # noqa: E402
from repro_torch.models.convert import to_torch          # noqa: E402

DT = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                     torch.bfloat16),
      "fp16": (jnp.float16, torch.float16), "int8": (jnp.int8, torch.int8),
      "int32": (jnp.int32, torch.int32),
      "e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
      "e5m2": (jnp.float8_e5m2, torch.float8_e5m2)}
TOL = {"fp32": 1e-5, "bf16": 3e-2, "fp16": 3e-2, "int8": 0.0, "e4m3": 3e-2,
       "e5m2": 3e-2}


def _err(out, ref):
    """max |out - ref| / max |ref|, in float64 (a torch tensor vs a jax
    array)."""
    o = out.double().numpy()
    r = np.asarray(ref).astype(np.float64)
    return np.abs(o - r).max() / (np.abs(r).max() + 1e-9)


def _operands(rng, m, k, n, dt, *, glu=False, bias=None, scale_a=False,
              scale_b=False, residual=False):
    """The same numpy inputs as (jax arrays, torch tensors)."""
    if dt == "int8":
        a = rng.integers(-127, 128, (m, k)).astype(np.int8)
        b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    else:
        a = rng.standard_normal((m, k)).astype(np.float32)
        b = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    jdt, tdt = DT[dt]
    n_out = n // 2 if glu else n
    extra = {
        "bias": (None if bias is None else rng.standard_normal(
            (n,) if bias == "row" else (m, n)).astype(np.float32)),
        "scale_a": rng.random(m).astype(np.float32) if scale_a else None,
        "scale_b": rng.random(n).astype(np.float32) if scale_b else None,
        "residual": (rng.standard_normal((m, n_out)).astype(np.float32)
                     if residual else None)}
    ja, jb = jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt)
    j_ops = jf.EpilogueOperands(**{k_: None if v is None else jnp.asarray(v)
                                   for k_, v in extra.items()})
    t_ops = tf.EpilogueOperands(**{k_: None if v is None else
                                   torch.from_numpy(v)
                                   for k_, v in extra.items()})
    if dt in ("e4m3", "e5m2"):      # the reference's fp8 bits, as they are
        ta, tb = to_torch(ja), to_torch(jb)
    else:
        ta, tb = torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt)
    if glu:
        jb, tb = jb.reshape(k, 2, n // 2), tb.reshape(k, 2, n // 2)
    return (ja, jb, j_ops), (ta, tb, t_ops)


def _epilogues(out_dt, **kw):
    bias = kw.pop("bias", None)
    jb = {None: JBias.ZERO, "row": JBias.ROW, "full": JBias.FULL}[bias]
    tb = {None: TBias.ZERO, "row": TBias.ROW, "full": TBias.FULL}[bias]
    jdt, tdt = DT[out_dt]
    return (jf.Epilogue(bias_type=jb, out_dtype=jdt, **kw),
            tf.Epilogue(bias_type=tb, out_dtype=tdt, **kw))


# (dtype, out dtype, (m, k, n), epilogue fields)
CASES = [
    ("fp32", "fp32", (33, 72, 130), {}),
    ("bf16", "bf16", (64, 128, 128), {}),
    ("fp16", "fp16", (20, 64, 96), {}),
    ("int8", "int32", (96, 128, 128), {}),
    ("int8", "int32", (5, 72, 200), {}),
    ("int8", "fp32", (40, 64, 96), dict(has_scale_a=True, has_scale_b=True,
                                        bias="row", activation="silu")),
    ("fp32", "fp32", (64, 64, 128), dict(bias="row")),
    ("fp32", "fp32", (64, 64, 128), dict(bias="full", has_residual=True)),
    ("fp32", "fp32", (16, 64, 128), dict(softcap=3.0, activation="tanh")),
    ("fp32", "fp32", (16, 64, 128), dict(glu=True, activation="silu")),
    ("bf16", "bf16", (24, 128, 256), dict(glu=True, activation="gelu",
                                          bias="row", has_scale_b=True,
                                          has_residual=True)),
    ("bf16", "fp32", (4, 128, 512), dict(softcap=30.0)),
    # fp8 (paper §4.1): e4m3fn and e5m2 accumulate in fp32
    ("e4m3", "fp32", (96, 128, 128), {}),
    ("e5m2", "fp32", (33, 72, 130), {}),
    ("e4m3", "fp32", (4, 128, 256), dict(glu=True, activation="silu")),
    ("e5m2", "fp32", (40, 64, 96), dict(bias="row", has_scale_b=True,
                                        has_residual=True,
                                        activation="gelu")),
]


def _kw(fields):
    kw = dict(fields)
    flags = dict(glu=kw.get("glu", False), bias=kw.get("bias"),
                 scale_a=kw.get("has_scale_a", False),
                 scale_b=kw.get("has_scale_b", False),
                 residual=kw.get("has_residual", False))
    return kw, flags


@pytest.mark.parametrize("route", ["torch", "kernel"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}-"
                         f"{'x'.join(map(str, c[2]))}-"
                         f"{'-'.join(sorted(c[3])) or 'plain'}")
def test_cute_matmul_vs_jax_xla_and_pallas(case, route):
    dt, out_dt, (m, k, n), fields = case
    kw, flags = _kw(fields)
    rng = np.random.default_rng(0)
    (ja, jb, jops), (ta, tb, tops) = _operands(rng, m, k, n, dt, **flags)
    jep, tep = _epilogues(out_dt, **kw)
    out = tf.cute_matmul(ta, tb, epilogue=tep, operands=tops, backend=route)
    assert out.dtype == DT[out_dt][1]
    ref_xla = jf.cute_matmul(ja, jb, epilogue=jep, operands=jops,
                             backend="xla")
    ref_pallas = j_fused(ja, jb, epilogue=jep, operands=jops,
                         block_shape=(32, 128, 128), interpret=True)
    tol = TOL[dt] if out_dt == "int32" or dt != "int8" else 1e-5
    for ref in (ref_xla, ref_pallas):
        assert _err(out, ref) <= tol, _err(out, ref)
    if out_dt == "int32":
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref_xla))


@pytest.mark.parametrize("dt", ["e4m3", "e5m2"])
def test_fp8_output_follows_the_policy(dt):
    """Without an out dtype, fp8 inputs give the fp8 policy's fp32, as the
    reference's ``cute_matmul`` does; the cost counter counts the launch's
    bytes at one an fp8 element."""
    rng = np.random.default_rng(1)
    (ja, jb, _), (ta, tb, _) = _operands(rng, 8, 32, 48, dt)
    from repro_torch.core import hlo_cost
    with hlo_cost.counting() as counter:
        out = tf.cute_matmul(ta, tb, backend="kernel")
    ref = jf.cute_matmul(ja, jb, backend="xla")
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    assert _err(out, ref) <= TOL[dt]
    # K1's launch counts one byte an fp8 element, four an fp32 output
    assert counter.cost.kernels["fused_matmul"]["bytes"] == \
        8 * 32 + 32 * 48 + 4 * 8 * 48


ACTS = list(jf.ACTIVATIONS)


@pytest.mark.parametrize("act", ACTS)
def test_every_activation_matches_jax(act):
    """fp32 at 1e-5: catches jax.nn.gelu's tanh form vs torch's erf."""
    rng = np.random.default_rng(1)
    (ja, jb, jops), (ta, tb, tops) = _operands(rng, 16, 64, 96, "fp32")
    jep, tep = _epilogues("fp32", activation=act)
    out = tf.cute_matmul(ta, tb, epilogue=tep, operands=tops)
    ref = jf.cute_matmul(ja, jb, epilogue=jep, operands=jops, backend="xla")
    assert _err(out, ref) <= 1e-5
    assert list(tf.ACTIVATIONS) == ACTS


def test_batched_linear_matches_jax():
    """Leading batch dims flatten through the kernel route."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 96)) / 8).astype(np.float32)
    bias = rng.standard_normal(96).astype(np.float32)
    ref = jf.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                    activation="relu", backend="xla")
    for route in ("kernel", "torch"):
        out = tf.linear(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(bias), activation="relu",
                        backend=route)
        assert out.shape == (2, 3, 96)
        assert _err(out, ref) <= 1e-5


def test_default_route_is_kernel_and_restorable():
    assert backend.default_matmul_backend() == "kernel"
    prev = backend.set_default_matmul_backend("torch")
    try:
        assert backend.matmul_backend_string() == "torch"
        # the DES prices schedules and serves no projection
        with pytest.raises(ValueError):
            backend.set_default_matmul_backend("desim")
        assert backend.matmul_backend_string() == "torch"
    finally:
        backend.set_default_matmul_backend(prev)
    assert backend.matmul_backend_string() == "kernel"


def test_trivial_int8_epilogue_stays_exact():
    """Sums beyond 2**24 stay exact in int32 (no float round-trip)."""
    a = torch.full((2, 4096), 127, dtype=torch.int8)
    b = torch.full((4096, 3), 127, dtype=torch.int8)
    out = fused_matmul(a, b, epilogue=tf.Epilogue(out_dtype=torch.int32))
    assert out.dtype == torch.int32
    assert int(out[0, 0]) == 127 * 127 * 4096


def test_ref_and_bf16_conversion_are_bit_exact():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = to_torch(np.asarray(jx))
    assert tx.dtype == torch.bfloat16
    assert torch.equal(tx, torch.from_numpy(x).to(torch.bfloat16))
    w = torch.from_numpy(x.T.copy())
    np.testing.assert_array_equal(
        fused_matmul_ref(torch.from_numpy(x), w).numpy(),
        tf.cute_matmul(torch.from_numpy(x), w, backend="torch").numpy())
