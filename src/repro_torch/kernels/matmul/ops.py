"""Wrapper of the fused matmul kernel (K1).

Flattens batch dims, lays a GLU weight ``(K, 2, N/2)`` out as ``(K, N)``
(gate columns, then up columns), flattens the epilogue operands to
match, and sends the 2-D problem to the CUDA kernel for CUDA tensors or
to its plain version for CPU tensors.  The kernel masks ragged edges
itself, so unlike the reference wrapper nothing is padded.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.fusion import (Epilogue, EpilogueOperands,
                                     _infer_policy)
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.task import BiasType
from repro_torch.kernels.matmul.matmul import (TILES, fused_matmul_cuda,
                                               fused_matmul_plain, tile_for)


def fused_matmul(a: torch.Tensor, b: torch.Tensor, *,
                 epilogue: Epilogue = Epilogue(),
                 operands: EpilogueOperands = EpilogueOperands(),
                 policy: Optional[PrecisionPolicy] = None) -> torch.Tensor:
    """epilogue(a @ b).  a: (..., M, K); b: (K, N) or (K, 2, N/2) for GLU.

    CUDA tensors launch the kernel on the tile ``select_tile`` picks (and
    count the launch in ``fused_matmul.launches`` and in
    ``fused_matmul.launches_by_tile``) or raise; CPU tensors run the
    plain version.
    """
    if policy is None:
        policy = _infer_policy(a)
    if epilogue.out_dtype is None:
        epilogue = dataclasses.replace(epilogue,
                                       out_dtype=policy.output_dtype)
    if b.dim() not in (2, 3) or (b.dim() == 3 and b.shape[1] != 2):
        raise ValueError(f"b must be (K, N) or GLU (K, 2, N/2), got "
                         f"{tuple(b.shape)}")
    lead = a.shape[:-2]
    m, k = a.shape[-2], a.shape[-1]
    a2 = a.reshape(-1, k)
    b2 = b.reshape(b.shape[0], -1)
    ops = EpilogueOperands(
        bias=(operands.bias.reshape(-1, operands.bias.shape[-1])
              if epilogue.bias_type == BiasType.FULL else operands.bias),
        scale_a=(operands.scale_a.reshape(-1)
                 if torch.is_tensor(operands.scale_a)
                 and operands.scale_a.dim() > 1 else operands.scale_a),
        scale_b=operands.scale_b,
        residual=(operands.residual.reshape(-1, operands.residual.shape[-1])
                  if operands.residual is not None else None))
    if a2.is_cuda:
        a2, b2 = a2.contiguous(), b2.contiguous()
        out = fused_matmul_cuda(a2, b2, epilogue, ops)
        fused_matmul.launches += 1
        fused_matmul.launches_by_tile[tile_for(a2, b2, epilogue)] += 1
    else:
        out = fused_matmul_plain(a2, b2, epilogue, ops, policy.accum_dtype)
    return out.reshape(*lead, m, out.shape[-1])


fused_matmul.launches = 0
fused_matmul.launches_by_tile = dict.fromkeys(TILES, 0)
