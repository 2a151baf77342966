"""Wrapper of the grouped MoE GEMM kernel (K4).

Lays a GLU weight ``(E, K, 2, N/2)`` out as ``(E, K, N)`` (gate columns,
then up columns) and sends the problem to the CUDA kernel for CUDA
tensors or to its plain version for CPU tensors.  The kernel masks
ragged edges itself, so unlike the reference wrapper nothing is padded,
and there is no ``block_shape`` or ``interpret``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.fusion import Epilogue
from repro_torch.core.task import BiasType
from repro_torch.kernels.moe.grouped_matmul import (grouped_matmul_cuda,
                                                    grouped_matmul_plain)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, *,
                   epilogue: Epilogue = Epilogue()) -> torch.Tensor:
    """x: (E, C, K); w: (E, K, N) (or (E, K, 2, N/2) for GLU)
    -> (E, C, N'), N' = N/2 under GLU.

    The epilogue is operand-free (softcap, activation, GLU, cast).  int8
    accumulates in int32 and returns int32 unless ``out_dtype`` says
    otherwise; other inputs accumulate in fp32 and return their dtype.
    CUDA tensors launch the kernel (and count the launch in
    ``grouped_matmul.launches``) or raise; CPU tensors run the plain
    version.
    """
    if (epilogue.has_scale_a or epilogue.has_scale_b
            or epilogue.has_residual or epilogue.bias_type != BiasType.ZERO):
        raise ValueError("the grouped matmul's epilogue takes no operands "
                         "(scales, bias, residual)")
    e, _, k = x.shape
    if w.dim() not in (3, 4) or tuple(w.shape[:2]) != (e, k):
        raise ValueError(f"w must be (E, K, N) or (E, K, 2, N/2) with "
                         f"E={e}, K={k}, got {tuple(w.shape)}")
    w = w.reshape(e, k, -1)
    int8 = x.dtype == torch.int8
    if epilogue.out_dtype is None:
        epilogue = dataclasses.replace(
            epilogue, out_dtype=torch.int32 if int8 else x.dtype)
    if x.is_cuda:
        out = grouped_matmul_cuda(x, w, epilogue)
        grouped_matmul.launches += 1
        return out
    return grouped_matmul_plain(x, w, epilogue,
                                torch.int32 if int8 else torch.float32)


grouped_matmul.launches = 0
