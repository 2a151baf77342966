"""Wrapper of the per-row int8 quantisation kernel (K3).

The kernel takes any row count, so unlike the reference wrapper nothing
is padded to a block of rows, and there is no ``block_m`` or
``interpret``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.quant.quant import (quantize_rowwise_cuda,
                                             quantize_rowwise_plain)


def quantize_rowwise(x: torch.Tensor):
    """x: (M, K) float -> (q int8 (M, K), scale f32 (M,)).

    CUDA tensors launch the kernel (and count the launch in
    ``quantize_rowwise.launches``) or raise; CPU tensors run the plain
    version.
    """
    if x.dim() != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    if x.is_cuda:
        out = quantize_rowwise_cuda(x)
        quantize_rowwise.launches += 1
        return out
    return quantize_rowwise_plain(x)


quantize_rowwise.launches = 0
