"""``cute_matmul``: the unified fused-matmul API (paper Listing 1, §4.3).

Every projection, MLP and logit GEMM of the port goes through this one
function.  It implements the paper's matrix–vector fusion contract: the
matrix engine produces accumulator tiles, and the "vector side" (bias,
(de)quant scales, activation, residual, soft-capping, GLU gating) is
applied as an *epilogue* without a round-trip through main memory.

Routes
------
* ``"torch"``  — ``torch.matmul`` in the accumulate dtype, then
  ``apply_epilogue`` as separate tensor ops.  The reference's ``"xla"``.
* ``"kernel"`` — the hand-written CUDA fused-matmul kernel
  (``kernels/matmul``), epilogue fused in registers.  The reference's
  ``"pallas"``.  On CPU tensors it runs the kernel's plain version.  The
  kernel masks ragged edges itself, so the reference's ``"auto"`` route
  (fall back when shapes miss the tiling contract) has no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import precision as prec
from repro_torch.core.precision import DataType, PrecisionPolicy
from repro_torch.core.task import BiasType


# ---------------------------------------------------------------------------
# Epilogue description — tile-local vector work fused after the matmul.
# ---------------------------------------------------------------------------

def _gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(
        0.7978845608028654 * (x + 0.044715 * x * x * x)))


ACTIVATIONS: "dict[str, Callable]" = {
    "none": lambda x: x,
    "relu": torch.relu,
    "relu2": lambda x: torch.square(torch.relu(x)),
    # jax.nn.gelu defaults to the tanh approximation.
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_tanh": _gelu_tanh,
    "silu": F.silu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
}

#: activation ids understood by the CUDA kernel's epilogue.
ACTIVATION_IDS = {name: i for i, name in enumerate(ACTIVATIONS)}


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """Vector-side work fused into the matmul (paper Fig. 5 'epilogue').

    Application order (matches the int8 inference pipeline of §5.1):
      acc -> *scale_a (per-row dequant) -> *scale_b (per-col dequant)
          -> +bias (zero/row/full) -> softcap -> activation
          -> GLU gate (optional; splits N in half: act(left) * right)
          -> +residual -> cast(out_dtype)
    """

    bias_type: BiasType = BiasType.ZERO
    activation: str = "none"
    softcap: float = 0.0            # gemma-style logit soft-capping; 0 = off
    glu: bool = False               # act(y[:, :n/2]) * y[:, n/2:]
    has_scale_a: bool = False       # per-row (M,) dequant scale
    has_scale_b: bool = False       # per-col (N,) dequant scale
    has_residual: bool = False
    out_dtype: Optional[torch.dtype] = None

    def __post_init__(self):
        if self.activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {self.activation!r}")

    @property
    def trivial(self) -> bool:
        """No vector work: the accumulator is only cast."""
        return (not self.has_scale_a and not self.has_scale_b
                and self.bias_type == BiasType.ZERO and not self.softcap
                and not self.glu and self.activation == "none"
                and not self.has_residual)


@dataclasses.dataclass(frozen=True)
class EpilogueOperands:
    """Tensors consumed by an Epilogue.  All optional, shapes as noted."""

    bias: Optional[torch.Tensor] = None       # (N,) for ROW, (M, N) for FULL
    scale_a: Optional[torch.Tensor] = None    # (M,) or scalar
    scale_b: Optional[torch.Tensor] = None    # (N,) or scalar
    residual: Optional[torch.Tensor] = None   # (M, N_out)


NO_EPILOGUE = Epilogue()
NO_OPERANDS = EpilogueOperands()


def apply_epilogue(acc: torch.Tensor, ep: Epilogue, ops: EpilogueOperands,
                   compute_dtype=torch.float32) -> torch.Tensor:
    """Plain-tensor epilogue application.  ``acc`` is (..., M, N).

    Shared by the ``"torch"`` route and the kernel's plain version; the
    CUDA kernel repeats the same arithmetic per element in registers.
    """
    out_dtype = ep.out_dtype if ep.out_dtype is not None else acc.dtype
    if ep.trivial:
        # Keep int32 accumulators exact (no float round-trip).
        return acc.to(out_dtype)
    y = acc.to(compute_dtype)
    if ep.has_scale_a:
        y = y * torch.as_tensor(ops.scale_a)[..., :, None].to(compute_dtype)
    if ep.has_scale_b:
        y = y * torch.as_tensor(ops.scale_b)[..., None, :].to(compute_dtype)
    if ep.bias_type == BiasType.ROW:
        y = y + ops.bias[..., None, :].to(compute_dtype)
    elif ep.bias_type == BiasType.FULL:
        y = y + ops.bias.to(compute_dtype)
    if ep.softcap:
        y = torch.tanh(y / ep.softcap) * ep.softcap
    if ep.glu:
        half = y.shape[-1] // 2
        y = ACTIVATIONS[ep.activation](y[..., :half]) * y[..., half:]
    else:
        y = ACTIVATIONS[ep.activation](y)
    if ep.has_residual:
        y = y + ops.residual.to(compute_dtype)
    return y.to(out_dtype)


# ---------------------------------------------------------------------------
# The unified entry point.
# ---------------------------------------------------------------------------

_POLICIES = {
    torch.int8: prec.INT8,
    torch.bfloat16: prec.policy(DataType.BF16, out_dtype=torch.bfloat16),
    torch.float16: prec.policy(DataType.FP16, out_dtype=torch.float16),
    torch.float8_e4m3fn: prec.FP8,
    torch.float8_e5m2: prec.policy(DataType.FP8_E5M2),
    torch.float32: prec.FP32,
}


def _infer_policy(a: torch.Tensor) -> PrecisionPolicy:
    return _POLICIES.get(a.dtype, prec.FP32)


def plain_matmul(a: torch.Tensor, b: torch.Tensor,
                 accum_dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` accumulated in ``accum_dtype`` with plain tensor ops.

    int8 goes through float64, where every int8 product and every partial
    sum below 2**53 is exact, so the int32 result is bit-exact on CPU and
    GPU alike (integer matmul has no CUDA library path).  Float inputs are
    upcast to fp32 first: the products of bf16/fp16 values are exact in
    fp32, as in an fp32-accumulating matrix unit.
    """
    if accum_dtype == torch.int32:
        return torch.matmul(a.double(), b.double()).to(torch.int32)
    return torch.matmul(a.to(accum_dtype), b.to(accum_dtype))


def cute_matmul(a: torch.Tensor, b: torch.Tensor, *,
                epilogue: Epilogue = NO_EPILOGUE,
                operands: EpilogueOperands = NO_OPERANDS,
                policy: Optional[PrecisionPolicy] = None,
                backend: Optional[str] = None) -> torch.Tensor:
    """C = epilogue(A @ B).  A: (..., M, K), B: (K, N) or GLU (K, 2, N/2).

    ``backend`` is a route string (``"torch"`` or ``"kernel"``); ``None``
    resolves the process-wide default from the ``repro_torch.backend``
    registry with tuned-dispatch precedence: ``set_default_matmul_backend``
    wins, else a route the current platform's tuning cache pins for this
    shape class, else ``"kernel"``.
    """
    if backend is None:
        from repro_torch.backend import matmul_backend_string  # lazy: no cycle
        m = a.shape[-2] if a.ndim >= 2 else 1
        backend = matmul_backend_string(
            shape=(m, b.shape[-1], a.shape[-1]))
    if policy is None:
        policy = _infer_policy(a)
    ep = epilogue
    if ep.out_dtype is None:
        ep = dataclasses.replace(ep, out_dtype=policy.output_dtype)

    if backend == "kernel":
        from repro_torch.kernels.matmul import ops as mm_ops  # lazy: no cycle
        return mm_ops.fused_matmul(a, b, epilogue=ep, operands=operands,
                                   policy=policy)
    if backend != "torch":
        raise ValueError(f"unknown cute_matmul route {backend!r}; "
                         "use 'torch' or 'kernel'")
    if ep.glu and b.ndim == 3:       # (K, 2, N/2) GLU layout
        b = b.reshape(b.shape[0], -1)
    acc = plain_matmul(a, b, policy.accum_dtype)
    return apply_epilogue(acc, ep, operands)


def linear(x: torch.Tensor, w: torch.Tensor,
           bias: Optional[torch.Tensor] = None, *,
           activation: str = "none", glu: bool = False, softcap: float = 0.0,
           out_dtype=None, backend: Optional[str] = None) -> torch.Tensor:
    """Convenience wrapper used by every model layer of the port."""
    ep = Epilogue(
        bias_type=BiasType.ROW if bias is not None else BiasType.ZERO,
        activation=activation, glu=glu, softcap=softcap,
        out_dtype=out_dtype if out_dtype is not None else x.dtype)
    return cute_matmul(x, w, epilogue=ep,
                       operands=EpilogueOperands(bias=bias), backend=backend)
