"""Wrapper of the fused matmul kernel (K1), and its autograd op.

Flattens batch dims, lays a GLU weight ``(K, 2, N/2)`` out as ``(K, N)``
(gate columns, then up columns), flattens the epilogue operands to
match, and sends the 2-D problem to the CUDA kernel for CUDA tensors or
to its plain version for CPU tensors.  The kernel masks ragged edges
itself, so unlike the reference wrapper nothing is padded.

Under autograd the call goes through the op ``repro_torch::fused_matmul``
(``FUSED_MATMUL_OP``): its forward is the same call, its backward
recomputes the accumulator through K1 where
the epilogue is not linear in it, takes the epilogue's vector-Jacobian
product by autograd of the shared plain ``apply_epilogue``, and forms
dA = d(acc) Bᵀ and dB = Aᵀ d(acc) with ``torch.matmul`` in fp32, as the
reference's autodiff of its fp32-accumulating matmul does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import NotPorted
from repro_torch.core import constraint, hlo_cost
from repro_torch.core.fusion import (Epilogue, EpilogueOperands,
                                     _infer_policy, apply_epilogue)
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.task import BiasType
from repro_torch.kernels.matmul.matmul import (TILES, fused_matmul_cuda,
                                               fused_matmul_plain,
                                               launch_cost, tile_for)

_ACC = Epilogue(out_dtype=torch.float32)   # the accumulator, as fp32
_K_UNIT = 16             # wgmma's K step for 16-bit inputs


def _round_up(x, m):
    return x + (-x) % m


def default_tiles(m: int, n: int, k: int, policy: PrecisionPolicy):
    """Eq.2-solved tile (Hopper's ``constraint.solve_tiles``), clamped to
    the problem rounded up to wgmma's units (64 rows, 8 columns, a K step
    of 16).  It is the model's answer, set beside K1's compiled tile
    (``matmul.TC_BM`` ...); K1's dispatch does not read it."""
    tc = constraint.solve_tiles(policy.data_type)
    bm = min(tc.bm, _round_up(m, constraint.WGMMA_M))
    bn = min(tc.bn, _round_up(n, constraint.WGMMA_N))
    bk = min(tc.bk, _round_up(k, _K_UNIT))
    return bm, bn, bk


def _run(a2: torch.Tensor, b2: torch.Tensor, ep: Epilogue,
         ops: EpilogueOperands, accum_dtype: torch.dtype) -> torch.Tensor:
    """The 2-D call: K1 on CUDA tensors (counted), its dry run on meta
    tensors, else the plain version; each is one launch to a cost
    counter."""
    if a2.is_cuda or a2.is_meta:
        a2, b2 = a2.contiguous(), b2.contiguous()
        out = fused_matmul_cuda(a2, b2, ep, ops)
        if a2.is_cuda:
            fused_matmul.launches += 1
            fused_matmul.launches_by_tile[tile_for(a2, b2, ep)] += 1
        hlo_cost.count("fused_matmul", launch_cost, a2, b2, ep)
        return out
    with hlo_cost.counted("fused_matmul", launch_cost, a2, b2, ep):
        return fused_matmul_plain(a2, b2, ep, ops, accum_dtype)


def _linear_in_acc(ep: Epilogue) -> bool:
    """The epilogue's Jacobian does not depend on the accumulator: bias,
    residual and the cast only."""
    return ep.activation == "none" and not ep.glu and not ep.softcap


def _epilogue(bias_type, activation, softcap, glu, has_residual, out_dtype):
    """The ``Epilogue`` that ``fused_matmul`` passes to the op field by
    field (an op's schema takes no dataclass; the tracked path has no
    dequant scales)."""
    return Epilogue(bias_type=BiasType(bias_type), activation=activation,
                    softcap=softcap, glu=glu, has_residual=has_residual,
                    out_dtype=out_dtype)


def _k1(a, b, bias, residual, bias_type, activation, softcap, glu,
        has_residual, out_dtype, accum_dtype):
    """The body of ``repro_torch::fused_matmul``: ``_run``."""
    return _run(a, b, _epilogue(bias_type, activation, softcap, glu,
                                has_residual, out_dtype),
                EpilogueOperands(bias=bias, residual=residual), accum_dtype)


def _setup(ctx, inputs, output):
    a, b, bias, residual, *fields, accum_dtype = inputs
    ctx.save_for_backward(a, b, bias, residual)
    ctx.ep = _epilogue(*fields)
    ctx.accum_dtype = accum_dtype


def _backward(ctx, g):
    a, b, bias, residual = ctx.saved_tensors
    ep = ctx.ep
    m, n = a.shape[0], b.shape[1]
    if _linear_in_acc(ep):
        # any accumulator gives the same vector-Jacobian product
        acc = g.new_zeros((), dtype=torch.float32).expand(m, n)
    else:
        acc = _run(a, b, _ACC, EpilogueOperands(), ctx.accum_dtype)
    with torch.enable_grad():
        # the epilogue's vector-Jacobian product in acc, bias, residual
        leaves = [acc.detach().requires_grad_()] + [
            None if t is None else t.detach().requires_grad_(need)
            for t, need in ((bias, ctx.needs_input_grad[2]),
                            (residual, ctx.needs_input_grad[3]))]
        y = apply_epilogue(leaves[0], ep, EpilogueOperands(
            bias=leaves[1], residual=leaves[2]))
        needed = [t is not None and t.requires_grad for t in leaves]
        got = iter(torch.autograd.grad(
            y, [t for t, n in zip(leaves, needed) if n], g))
        d_acc, d_bias, d_res = (next(got) if n else None for n in needed)
    d_a = d_b = None
    if ctx.needs_input_grad[0]:
        d_a = torch.matmul(d_acc, b.float().T).to(a.dtype)
    if ctx.needs_input_grad[1]:
        d_b = torch.matmul(a.float().T, d_acc).to(b.dtype)
    return (d_a, d_b, d_bias, d_res) + (None,) * 7


# K1's forward as an op the dispatcher sees, the path of every call that
# autograd tracks: a selective checkpoint can keep its output
# (``models.common.remat``, "dots"), and its backward is ``_backward``.
# Meta tensors take the same body (the dry run).
_k1_op = torch.library.custom_op(
    "repro_torch::fused_matmul", _k1, mutates_args=(),
    schema="(Tensor a, Tensor b, Tensor? bias, Tensor? residual, "
           "str bias_type, str activation, float softcap, bool glu, "
           "bool has_residual, ScalarType out_dtype, "
           "ScalarType accum_dtype) -> Tensor")
_k1_op.register_fake(_k1)
_k1_op.register_autograd(_backward, setup_context=_setup)
#: the op's overload, for a checkpoint policy
FUSED_MATMUL_OP = torch.ops.repro_torch.fused_matmul.default


def fused_matmul(a: torch.Tensor, b: torch.Tensor, *,
                 epilogue: Epilogue = Epilogue(),
                 operands: EpilogueOperands = EpilogueOperands(),
                 policy: Optional[PrecisionPolicy] = None) -> torch.Tensor:
    """epilogue(a @ b).  a: (..., M, K); b: (K, N) or (K, 2, N/2) for GLU.

    CUDA tensors launch the kernel on the tile ``select_tile`` picks (and
    count the launch in ``fused_matmul.launches`` and in
    ``fused_matmul.launches_by_tile``) or raise; ``meta`` tensors take
    the same path but for the launch (a dry run); CPU tensors run the
    plain version.  A cost counter (``core.hlo_cost``) counts each as one
    launch (``matmul.launch_cost``).  When grad mode is on and an input
    requires grad the call goes through ``FUSED_MATMUL_OP``, on both
    devices; its backward's K1 launches are counted too.  The int8 and
    dequant-scale paths have no backward and raise there.
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
    tracked = torch.is_grad_enabled() and any(
        torch.is_tensor(t) and t.requires_grad
        for t in (a2, b2, ops.bias, ops.scale_a, ops.scale_b, ops.residual))
    if tracked:
        if (epilogue.has_scale_a or epilogue.has_scale_b
                or not a.is_floating_point()):
            raise NotPorted(
                "fused_matmul (K1) has no backward for int8 operands or "
                "dequant scales (ROADMAP queue 1, item K); call it under "
                "torch.no_grad()")
        out = FUSED_MATMUL_OP(
            a2, b2, ops.bias, ops.residual, epilogue.bias_type.value,
            epilogue.activation, float(epilogue.softcap), epilogue.glu,
            epilogue.has_residual, epilogue.out_dtype, policy.accum_dtype)
    else:
        out = _run(a2, b2, epilogue, ops, policy.accum_dtype)
    return out.reshape(*lead, m, out.shape[-1])


fused_matmul.launches = 0
fused_matmul.launches_by_tile = dict.fromkeys(TILES, 0)
