"""The per-row int8 quantisation kernel (K3) and its plain version.

``quantize_rowwise_cuda`` launches ``csrc/quantize_rowwise.cu``, the
Hopper counterpart of the reference's Pallas ``quantize_rowwise_kernel``
(``repro/kernels/quant/quant.py``).  ``quantize_rowwise_plain`` computes
the same function with plain tensor ops: the CPU tests run it, and
``chip_smoke.py`` holds the kernel against it on the card, bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.quant.ref import quantize_rowwise_ref

_IN_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        from repro_torch.kernels import build
        fn = build.load("quantize_rowwise").quantize_rowwise_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, i, i, p]
        fn.restype = i
        _fn = fn
    return _fn


def quantize_rowwise_plain(x: torch.Tensor):
    """(q int8 (M, K), scale fp32 (M,)) with plain tensor ops."""
    return quantize_rowwise_ref(x)


def quantize_rowwise_cuda(x: torch.Tensor):
    """Launch the CUDA kernel on a CUDA tensor ``x`` (M, K)."""
    if x.dtype not in _IN_CODES:
        raise NotImplementedError(
            f"the CUDA row quantiser takes float32, float16 or bfloat16, "
            f"got {x.dtype}")
    m, k = x.shape
    q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    scale = torch.empty((m,), dtype=torch.float32, device=x.device)
    if m == 0:
        return q, scale
    x = x.contiguous()
    err = _launcher()(_IN_CODES[x.dtype], x.data_ptr(), q.data_ptr(),
                      scale.data_ptr(), m, k,
                      torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quantize_rowwise kernel launch failed: CUDA "
                           f"error {err}")
    return q, scale
