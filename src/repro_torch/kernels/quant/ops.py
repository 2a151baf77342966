"""Wrapper of the per-row int8 quantisation kernel (K3).

The kernel takes any row count, so unlike the reference wrapper nothing
is padded to a block of rows, and there is no ``block_m`` or
``interpret``.
"""

from __future__ import annotations

import torch

from repro_torch.core import hlo_cost
from repro_torch.kernels import refuse_autograd
from repro_torch.kernels.quant.quant import (launch_cost,
                                             quantize_rowwise_cuda,
                                             quantize_rowwise_plain)


def quantize_rowwise(x: torch.Tensor):
    """x: (M, K) float -> (q int8 (M, K), scale f32 (M,)).

    CUDA tensors launch the kernel (and count the launch in
    ``quantize_rowwise.launches``) or raise; ``meta`` tensors take the
    same path but for the launch; CPU tensors run the plain version.  A
    cost counter (``core.hlo_cost``) counts each as one launch
    (``launch_cost``).  It has no backward: a call that autograd would track
    raises (``kernels.refuse_autograd``).
    """
    if x.dim() != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    refuse_autograd("quantize_rowwise (K3)", "queue 1, item K", x)
    if x.is_cuda or x.is_meta:
        out = quantize_rowwise_cuda(x)
        if x.is_cuda:
            quantize_rowwise.launches += 1
        hlo_cost.count("quantize_rowwise", launch_cost, x)
        return out
    with hlo_cost.counted("quantize_rowwise", launch_cost, x):
        return quantize_rowwise_plain(x)


quantize_rowwise.launches = 0
