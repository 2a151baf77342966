"""Wrapper of the grouped MoE GEMM kernel (K4).

Lays a GLU weight ``(E, K, 2, N/2)`` out as ``(E, K, N)`` (gate columns,
then up columns) and sends the problem to the CUDA kernel for CUDA
tensors or to its plain version for CPU tensors.  The kernel masks
ragged edges itself, so unlike the reference wrapper nothing is padded,
and there is no ``block_shape`` or ``interpret``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.core import hlo_cost
from repro_torch.core.fusion import ACTIVATIONS, Epilogue
from repro_torch.core.task import BiasType
from repro_torch.kernels import refuse_autograd
from repro_torch.kernels.matmul.matmul import TILES
from repro_torch.kernels.moe.grouped_matmul import (grouped_matmul_cuda,
                                                    grouped_matmul_plain,
                                                    launch_cost, tile_for)

#: fp8 input types, whose output is fp32 by default
FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, *,
                   epilogue: Epilogue = Epilogue(),
                   rows: Optional[torch.Tensor] = None,
                   max_rows: Optional[int] = None,
                   max_experts: Optional[int] = None) -> torch.Tensor:
    """x: (E, C, K); w: (E, K, N) (or (E, K, 2, N/2) for GLU)
    -> (E, C, N'), N' = N/2 under GLU.

    The epilogue is operand-free (softcap, activation, GLU, cast).  int8
    accumulates in int32 and returns int32 unless ``out_dtype`` says
    otherwise; fp8 accumulates in fp32 and returns fp32 (the fp8
    policy's output, as K1's; the reference's wrapper keeps x's dtype);
    other inputs accumulate in fp32 and return their dtype.

    Promises the caller may make, so that the kernel skips work; the
    result stays the same function of ``x``:

    * ``rows``: an int32 tensor of shape (E,) on x's device; rows[e]
      promises that x[e, rows[e]:] is zero.  A block whose rows all lie at
      or past rows[e] loads nothing and writes epilogue(0).  The host
      never reads it, so a caller need not synchronise;
    * ``max_rows``: a host int; x[:, max_rows:] is zero;
    * ``max_experts``: a host int; at most that many experts hold a
      nonzero row.  It sizes the decode tile's K split.

    CUDA tensors launch the kernel on the tile K1's ``select_tile`` picks
    with M = C (and count the launch in ``grouped_matmul.launches`` and
    ``grouped_matmul.launches_by_tile``) or raise; ``meta`` tensors take
    the same path but for the launch; CPU tensors run the plain version,
    which needs none of the promises.  A cost counter
    (``core.hlo_cost``) counts each as one launch (``launch_cost``).  It
    has no backward: a call that autograd would track raises
    (``kernels.refuse_autograd``).
    """
    if (epilogue.has_scale_a or epilogue.has_scale_b
            or epilogue.has_residual or epilogue.bias_type != BiasType.ZERO):
        raise ValueError("the grouped matmul's epilogue takes no operands "
                         "(scales, bias, residual)")
    refuse_autograd("grouped_matmul (K4)", "queue 1, item G", x, w)
    e, _, k = x.shape
    if w.dim() not in (3, 4) or tuple(w.shape[:2]) != (e, k):
        raise ValueError(f"w must be (E, K, N) or (E, K, 2, N/2) with "
                         f"E={e}, K={k}, got {tuple(w.shape)}")
    if rows is not None and (rows.dtype != torch.int32
                             or tuple(rows.shape) != (e,)
                             or rows.device != x.device):
        raise ValueError(f"rows must be int32 of shape ({e},) on "
                         f"{x.device}, got {rows.dtype} {tuple(rows.shape)} "
                         f"on {rows.device}")
    w = w.reshape(e, k, -1)
    int8 = x.dtype == torch.int8
    if epilogue.out_dtype is None:
        epilogue = dataclasses.replace(
            epilogue, out_dtype=torch.int32 if int8 else torch.float32
            if x.dtype in FP8 else x.dtype)
    if x.is_cuda or x.is_meta:
        x, w = x.contiguous(), w.contiguous()
        out = grouped_matmul_cuda(
            x, w, epilogue,
            rows.contiguous() if rows is not None else None, max_rows,
            max_experts)
        if x.is_cuda:
            grouped_matmul.launches += 1
            grouped_matmul.launches_by_tile[tile_for(x, w, epilogue)] += 1
        hlo_cost.count("grouped_matmul", launch_cost, x, w, epilogue, rows)
        return out
    with hlo_cost.counted("grouped_matmul", launch_cost, x, w, epilogue,
                          rows):
        return grouped_matmul_plain(x, w, epilogue,
                                    torch.int32 if int8 else torch.float32)


grouped_matmul.launches = 0
grouped_matmul.launches_by_tile = dict.fromkeys(TILES, 0)


@functools.lru_cache(maxsize=None)
def _act_at_zero(activation: str) -> float:
    return float(ACTIVATIONS[activation](torch.zeros(())))


def keeps_zero_rows(epilogue: Epilogue) -> bool:
    """Whether ``epilogue`` maps a zero accumulator row to a zero row, so
    that a grouped call's ``rows`` hold for its output too.  Under GLU,
    act(gate) * 0 = 0; else the activation must give act(0) = 0 (every
    one but ``sigmoid``, whose act(0) is 0.5).  Softcap and the cast keep
    0."""
    return epilogue.glu or _act_at_zero(epilogue.activation) == 0.0
