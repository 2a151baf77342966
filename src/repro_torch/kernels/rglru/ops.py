"""Wrapper of the RG-LRU scan kernel (K5).

The kernel pads nothing: a block on 32 channels of one batch row walks
any T in chunks and masks a ragged C itself, so unlike the reference
wrapper there is no ``chunk``, ``block_c`` or ``interpret``.  It also
takes an initial state and returns the final one, which the reference's
kernel does not.
"""

from __future__ import annotations

import torch

from repro_torch.core import hlo_cost
from repro_torch.kernels import refuse_autograd
from repro_torch.kernels.rglru.rglru import (launch_cost, rglru_scan_cuda,
                                             rglru_scan_plain)


def rglru_scan(log_a: torch.Tensor, x: torch.Tensor, initial_state=None):
    """log_a, x: (B, T, C) float32 -> (h (B, T, C), h_T (B, C)), fp32.

    CUDA tensors launch the kernel (and count the launch in
    ``rglru_scan.launches``) or raise; ``meta`` tensors take the same
    path but for the launch; CPU tensors run the plain version.  A cost
    counter (``core.hlo_cost``) counts each as one launch
    (``launch_cost``).
    It has no backward: a call that autograd would track raises
    (``kernels.refuse_autograd``).
    """
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, C), got {tuple(x.shape)}")
    refuse_autograd("rglru_scan (K5)", "queue 1, item H", log_a, x,
                    initial_state)
    if x.is_cuda or x.is_meta:
        out = rglru_scan_cuda(log_a, x, initial_state)
        if x.is_cuda:
            rglru_scan.launches += 1
        hlo_cost.count("rglru_scan", launch_cost, log_a, x, initial_state)
        return out
    with hlo_cost.counted("rglru_scan", launch_cost, log_a, x,
                          initial_state):
        return rglru_scan_plain(log_a, x, initial_state)


rglru_scan.launches = 0
