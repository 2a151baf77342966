"""The grouped MoE GEMM kernel (K4) and its plain version.

``grouped_matmul_cuda`` launches ``csrc/grouped_matmul.cu``, the Hopper
counterpart of the reference's Pallas ``grouped_matmul_kernel``
(``repro/kernels/moe/grouped_matmul.py``).  ``grouped_matmul_plain``
computes the same function with plain tensor ops: the CPU tests run it,
and ``chip_smoke.py`` holds the kernel against it on the card.

Both take the problem the wrapper (``ops.grouped_matmul``) prepared:
``x`` (E, C, K), ``w`` (E, K, N) with N = 2 * N_out under GLU (gate
columns, then up columns), and an operand-free epilogue whose
``out_dtype`` is set.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.fusion import ACTIVATION_IDS, Epilogue
from repro_torch.kernels.matmul.matmul import _IN_CODES, _OUT_CODES, _aligned
from repro_torch.kernels.moe.ref import grouped_matmul_ref

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        from repro_torch.kernels import build
        fn = build.load("grouped_matmul").grouped_matmul_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i,
                       i, i, i, p]
        fn.restype = i
        _fn = fn
    return _fn


def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor, ep: Epilogue,
                         accum_dtype: torch.dtype) -> torch.Tensor:
    """``epilogue(x[e] @ w[e])``: a batched product in ``accum_dtype``,
    then ``apply_epilogue``."""
    return grouped_matmul_ref(x, w, epilogue=ep, accum_dtype=accum_dtype)


def grouped_matmul_cuda(x: torch.Tensor, w: torch.Tensor,
                        ep: Epilogue) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors."""
    if w.device != x.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    if x.dtype not in _IN_CODES or w.dtype != x.dtype:
        raise NotImplementedError(
            f"the CUDA grouped matmul takes float32, float16, bfloat16 or "
            f"int8 operands of one dtype, got {x.dtype} x {w.dtype}")
    if ep.out_dtype not in _OUT_CODES:
        raise NotImplementedError(f"out_dtype {ep.out_dtype} is not one of "
                                  f"{sorted(map(str, _OUT_CODES))}")
    e, c, k = x.shape
    n = w.shape[2]
    if ep.glu and n % 2:
        raise ValueError(f"GLU needs an even N, got {n}")
    n_out = n // 2 if ep.glu else n
    out = torch.empty((e, c, n_out), dtype=ep.out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    x, w = x.contiguous(), w.contiguous()
    vec = 16 // x.element_size()
    vec_b = _aligned(w, n, vec) and (not ep.glu or n_out % vec == 0)
    err = _launcher()(
        _IN_CODES[x.dtype], x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c,
        n, k, int(ep.glu), int(_aligned(x, k, vec)), int(vec_b),
        float(ep.softcap), ACTIVATION_IDS[ep.activation], int(ep.trivial),
        _OUT_CODES[ep.out_dtype], out.element_size(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grouped_matmul kernel launch failed: CUDA "
                           f"error {err}")
    return out
