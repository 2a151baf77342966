"""The fused GEMM + epilogue kernel (K1) and its plain version.

``fused_matmul_cuda`` launches ``csrc/fused_matmul.cu``, the Hopper
counterpart of the reference's Pallas ``fused_matmul_kernel``
(``repro/kernels/matmul/matmul.py``).  ``fused_matmul_plain`` computes the
same function with plain tensor ops: the CPU tests run it, and
``chip_smoke.py`` holds the kernel against it on the card.

Both take the 2-D problem the wrapper (``ops.fused_matmul``) prepared:
``a`` (M, K), ``b`` (K, N) with N = 2 * N_out under GLU (gate columns,
then up columns), and an epilogue whose ``out_dtype`` is set.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.fusion import (ACTIVATION_IDS, Epilogue,
                                     EpilogueOperands, apply_epilogue,
                                     plain_matmul)
from repro_torch.core.task import BiasType

_IN_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2,
             torch.int8: 3}
_OUT_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2,
              torch.int32: 3}
_BIAS_CODES = {BiasType.ZERO: 0, BiasType.ROW: 1, BiasType.FULL: 2}

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        from repro_torch.kernels import build
        fn = build.load("fused_matmul").fused_matmul_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, i, i, i, i, i, i, i, p, p, p, p,
                       ctypes.c_float, i, i, i, p]
        fn.restype = i
        _fn = fn
    return _fn


def fused_matmul_plain(a: torch.Tensor, b: torch.Tensor, ep: Epilogue,
                       ops: EpilogueOperands,
                       accum_dtype: torch.dtype) -> torch.Tensor:
    """``epilogue(a @ b)`` with plain tensor ops."""
    return apply_epilogue(plain_matmul(a, b, accum_dtype), ep, ops)


def _aligned(t: torch.Tensor, row: int, elems: int) -> bool:
    """16-byte loads are safe: aligned base and rows of whole vectors."""
    return t.data_ptr() % 16 == 0 and row % elems == 0


def _f32(x, shape, device):
    """An epilogue operand as a contiguous fp32 tensor of ``shape``."""
    x = torch.as_tensor(x, device=device)
    return x.to(torch.float32).expand(shape).contiguous()


def fused_matmul_cuda(a: torch.Tensor, b: torch.Tensor, ep: Epilogue,
                      ops: EpilogueOperands) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors."""
    if b.device != a.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.dtype not in _IN_CODES or b.dtype != a.dtype:
        raise NotImplementedError(
            f"the CUDA fused matmul takes float32, float16, bfloat16 or "
            f"int8 operands of one dtype, got {a.dtype} x {b.dtype}")
    if ep.out_dtype not in _OUT_CODES:
        raise NotImplementedError(f"out_dtype {ep.out_dtype} is not one of "
                                  f"{sorted(map(str, _OUT_CODES))}")
    m, k = a.shape
    n = b.shape[1]
    if ep.glu and n % 2:
        raise ValueError(f"GLU needs an even N, got {n}")
    n_out = n // 2 if ep.glu else n
    out = torch.empty((m, n_out), dtype=ep.out_dtype, device=a.device)
    if out.numel() == 0:
        return out
    a, b = a.contiguous(), b.contiguous()
    vec = 16 // a.element_size()
    keep = []        # fp32 operand copies must outlive the launch

    def ptr(x, shape):
        if x is None:
            return None
        t = _f32(x, shape, a.device)
        keep.append(t)
        return t.data_ptr()

    bias = None
    if ep.bias_type == BiasType.ROW:
        bias = ptr(ops.bias, (n,))
    elif ep.bias_type == BiasType.FULL:
        bias = ptr(ops.bias, (m, n))
    scale_a = ptr(ops.scale_a, (m,)) if ep.has_scale_a else None
    scale_b = ptr(ops.scale_b, (n,)) if ep.has_scale_b else None
    residual = ptr(ops.residual, (m, n_out)) if ep.has_residual else None
    vec_b = _aligned(b, n, vec) and (not ep.glu or n_out % vec == 0)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _launcher()(
        _IN_CODES[a.dtype], a.data_ptr(), b.data_ptr(), out.data_ptr(),
        m, n, k, int(ep.glu), int(_aligned(a, k, vec)), int(vec_b),
        _BIAS_CODES[ep.bias_type], bias, scale_a, scale_b, residual,
        float(ep.softcap), ACTIVATION_IDS[ep.activation], int(ep.trivial),
        _OUT_CODES[ep.out_dtype], stream)
    if err != 0:
        raise RuntimeError(f"fused_matmul kernel launch failed: CUDA error "
                           f"{err}")
    return out
