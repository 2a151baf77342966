"""The fused GEMM + epilogue kernel (K1) and its plain version.

``fused_matmul_cuda`` launches one of K1's three CUDA tiles, the Hopper
counterparts of the reference's Pallas ``fused_matmul_kernel``
(``repro/kernels/matmul/matmul.py``); ``select_tile`` alone decides which:

* ``"decode"`` (``csrc/decode_tile.cuh``): M <= 8 rows, any input type;
  bound by reading B once;
* ``"tc"`` (``csrc/fused_matmul_sm90.cu``, the tile of
  ``csrc/tc_tile.cuh``): bf16/fp16 with M > 8 whose rows TMA can load
  (16-byte multiples); wgmma on the tensor cores;
* ``"simt"`` (``csrc/gemm_tile.cuh``): everything else (fp32, int8, fp8,
  rows TMA refuses).

The input types are the reference's: fp32, fp16, bf16 and fp8 (e4m3fn,
e5m2) accumulate in fp32, int8 in int32.  The tiles read fp8 operands
as they lie, one byte an element, and decode them in registers: no
upcast copy is made.

``fused_matmul_plain`` computes the same function with plain tensor ops:
the CPU tests run it, and ``chip_smoke.py`` holds every tile against it
on the card.

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
from repro_torch.core.hlo_cost import tensor_bytes
from repro_torch.core.task import BiasType
from repro_torch.kernels import bind_device, launcher, stream

_IN_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2,
             torch.int8: 3, torch.float8_e4m3fn: 4, torch.float8_e5m2: 5}
_OUT_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2,
              torch.int32: 3}
_BIAS_CODES = {BiasType.ZERO: 0, BiasType.ROW: 1, BiasType.FULL: 2}

TILES = ("decode", "tc", "simt")
DECODE_ROWS = 8          # the decode tile's largest M
TMA_ALIGN = 8            # 16-bit elements in TMA's 16-byte row-stride unit
DECODE_COLS = 256        # output columns a decode block owns
DECODE_BLOCKS = 264      # blocks that fill the card: two on each of 132 SMs
DECODE_MIN_ROWS = 128    # fewest K rows a split of the decode tile takes
DECODE_ROUND = 64        # a split's K rows are a multiple of the rows one
                         # round of the block's 8 warps loads
# The tensor-core tile as ``csrc/tc_tile.cuh`` compiles it for K1: a block
# of TC_WG = 2 warpgroups owns BM = 64 * TC_WG rows and TC_BN columns,
# and walks K in TC_BK-deep stages, TC_STAGES of them in its ring.
TC_WG = 2
TC_BM = 64 * TC_WG
TC_BN = 128
TC_BK = 64
TC_STAGES = 4

_fn = None               # the SIMT tile (fused_matmul.cu)
_decode_fn = None        # the decode tile (fused_matmul.cu)
_tc_fn = None            # the tensor-core tile (fused_matmul_sm90.cu)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the epilogue's arguments, common to the three C entry points
_EPI_ARGS = [_I, _P, _P, _P, _P, _F, _I, _I, _I, _P]


def _bind(stem: str, symbol: str, head: list):
    from repro_torch.kernels import build
    fn = getattr(build.load(stem), symbol)
    fn.argtypes = head + _EPI_ARGS
    fn.restype = _I
    return fn


def _launcher():
    global _fn
    if _fn is None:
        _fn = _bind("fused_matmul", "fused_matmul_launch",
                    [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I])
    return _fn


def _decode_launcher():
    global _decode_fn
    if _decode_fn is None:
        _decode_fn = _bind("fused_matmul", "fused_matmul_decode_launch",
                           [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P])
    return _decode_fn


def _tc_launcher():
    global _tc_fn
    if _tc_fn is None:
        _tc_fn = _bind("fused_matmul_sm90", "fused_matmul_tc_launch",
                       [_I, _P, _P, _P, _I, _I, _I, _I])
    return _tc_fn


def select_tile(m: int, n: int, k: int, dtype: torch.dtype, glu: bool,
                aligned: bool) -> str:
    """The tile that computes an (m, k) @ (k, n) product: K1's rule, and
    K4's with m = C, the rows of one expert.

    ``aligned``: both operands start on 16-byte boundaries.  M <= 8 takes
    the decode tile, whatever the type.  Above that, bf16 and fp16 take
    the tensor-core tile when TMA can load every row: A's rows (k), B's
    rows (n) and under GLU each half of B's row (n / 2) are whole 16-byte
    units.  fp32 stays off the tensor cores (TF32 would break its parity
    tolerance), and int8 and fp8 too (wgmma's s8 and fp8 forms take only
    K-major B, and the weights are (K, N)); they and the rows TMA refuses
    take the SIMT tile.  No tile falls back to another: a failed launch
    raises.
    """
    if m <= DECODE_ROWS:
        return "decode"
    if (dtype in (torch.bfloat16, torch.float16) and aligned
            and k % TMA_ALIGN == 0 and n % TMA_ALIGN == 0
            and (not glu or (n // 2) % TMA_ALIGN == 0)):
        return "tc"
    return "simt"


def tile_for(a: torch.Tensor, b: torch.Tensor, ep: Epilogue) -> str:
    """``select_tile`` for contiguous 2-D operands of one call."""
    return select_tile(a.shape[0], b.shape[1], a.shape[1], a.dtype, ep.glu,
                       a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)


def decode_split(n_out: int, k: int,
                 groups: int = 1) -> "tuple[int, int]":
    """(splits, rows a split takes) of the decode tile's K: as many splits
    as keep the blocks within one wave of ``DECODE_BLOCKS`` (a second,
    partial wave would cost nearly a full one), none shorter than
    ``DECODE_MIN_ROWS`` rows.  ``groups``: the problems that do work (K4:
    the experts that can hold a row), each with its own column tiles."""
    tiles = groups * -(-n_out // DECODE_COLS)
    splits = max(1, min(DECODE_BLOCKS // tiles, k // DECODE_MIN_ROWS))
    k_split = -(-k // splits)
    k_split = -(-k_split // DECODE_ROUND) * DECODE_ROUND
    return -(-k // k_split), k_split


def launch_cost(a: torch.Tensor, b: torch.Tensor,
                ep: Epilogue) -> "tuple[float, int]":
    """(FLOPs, bytes) of one call on the 2-D problem.  FLOPs: 2·M·N·K
    with N the full width under GLU, the dot of the reference's ``xla``
    route.  Bytes: a, b, the epilogue's operands as the launch takes them
    (fp32) and the output."""
    m, k = a.shape
    n = b.shape[1]
    n_out = n // 2 if ep.glu else n
    f32 = {BiasType.ROW: n, BiasType.FULL: m * n}.get(ep.bias_type, 0)
    f32 += (m if ep.has_scale_a else 0) + (n if ep.has_scale_b else 0)
    f32 += m * n_out if ep.has_residual else 0
    return (2.0 * m * n * k, tensor_bytes(a) + tensor_bytes(b) + 4 * f32
            + m * n_out * ep.out_dtype.itemsize)


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
    """Launch the CUDA kernel on contiguous CUDA tensors, on the tile
    ``tile_for`` names (on ``meta`` tensors, all but the launch)."""
    bind_device(a)
    if b.device != a.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the CUDA fused matmul takes contiguous operands")
    if a.dtype not in _IN_CODES or b.dtype != a.dtype:
        raise NotImplementedError(
            f"the CUDA fused matmul takes operands of one of "
            f"{sorted(map(str, _IN_CODES))}, of one dtype, got {a.dtype} x "
            f"{b.dtype}")
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
    tile = tile_for(a, b, ep)
    epi = (_BIAS_CODES[ep.bias_type], bias, scale_a, scale_b, residual,
           float(ep.softcap), ACTIVATION_IDS[ep.activation], int(ep.trivial),
           _OUT_CODES[ep.out_dtype], stream(a))
    head = (_IN_CODES[a.dtype], a.data_ptr(), b.data_ptr(), out.data_ptr(),
            m, n, k, int(ep.glu))
    if tile == "decode":
        splits, k_split = decode_split(n_out, k)
        ws = None
        if splits > 1:
            ws = torch.empty((splits, m, n), device=a.device,
                             dtype=torch.int32 if a.dtype == torch.int8
                             else torch.float32)
            keep.append(ws)
        err = launcher(_decode_launcher, a)(
            *head, int(vec_b), splits, k_split,
            ws.data_ptr() if ws is not None else None, *epi)
    elif tile == "tc":
        err = launcher(_tc_launcher, a)(*head, *epi)
    else:
        err = launcher(_launcher, a)(*head, int(_aligned(a, k, vec)),
                                     int(vec_b), *epi)
    if err != 0:
        raise RuntimeError(f"fused_matmul kernel launch failed ({tile} "
                           f"tile): CUDA error {err}")
    return out
