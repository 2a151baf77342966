"""The grouped MoE GEMM kernel (K4) and its plain version.

``grouped_matmul_cuda`` launches one of K4's three CUDA tiles, the Hopper
counterparts of the reference's Pallas ``grouped_matmul_kernel``
(``repro/kernels/moe/grouped_matmul.py``): K1's tiles with the expert as
one more coordinate, picked by K1's one rule
(``kernels/matmul/matmul.py::select_tile`` with M = C):

* ``"decode"`` (``csrc/grouped_matmul.cu`` on ``csrc/decode_tile.cuh``):
  C <= 8 rows an expert, any input type;
* ``"tc"`` (``csrc/grouped_matmul_sm90.cu`` on ``csrc/tc_tile.cuh``):
  bf16/fp16 whose rows TMA can load;
* ``"simt"`` (``csrc/grouped_matmul.cu`` on ``csrc/gemm_tile.cuh``): the
  rest (fp32, int8, rows TMA refuses).

``grouped_matmul_plain`` computes the same function with plain tensor
ops: the CPU tests run it, and ``chip_smoke.py`` holds every tile against
it on the card.

Both take the problem the wrapper (``ops.grouped_matmul``) prepared:
``x`` (E, C, K), ``w`` (E, K, N) with N = 2 * N_out under GLU (gate
columns, then up columns), and an operand-free epilogue whose
``out_dtype`` is set.  The kernel also takes the wrapper's promises of
zero rows (``rows``, ``max_rows``) and ``max_experts``; the plain version
needs none of them.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.fusion import ACTIVATION_IDS, Epilogue
from repro_torch.kernels.matmul import matmul as mm
from repro_torch.kernels.moe.ref import grouped_matmul_ref

_fn = None               # the SIMT tile (grouped_matmul.cu)
_decode_fn = None        # the decode tile (grouped_matmul.cu)
_tc_fn = None            # the tensor-core tile (grouped_matmul_sm90.cu)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the arguments after the tile's own, common to the three C entry points:
# rows, softcap, activation, trivial, out code, stream
_TAIL = [_P, _F, _I, _I, _I, _P]


def _bind(stem: str, symbol: str, head: list):
    from repro_torch.kernels import build
    fn = getattr(build.load(stem), symbol)
    fn.argtypes = [_I, _P, _P, _P, _I, _I, _I, _I, _I] + head + _TAIL
    fn.restype = _I
    return fn


def _launcher():
    global _fn
    if _fn is None:
        _fn = _bind("grouped_matmul", "grouped_matmul_launch", [_I, _I])
    return _fn


def _decode_launcher():
    global _decode_fn
    if _decode_fn is None:
        _decode_fn = _bind("grouped_matmul", "grouped_matmul_decode_launch",
                           [_I, _I, _I, _I, _P])
    return _decode_fn


def _tc_launcher():
    global _tc_fn
    if _tc_fn is None:
        _tc_fn = _bind("grouped_matmul_sm90", "grouped_matmul_tc_launch", [])
    return _tc_fn


def tile_for(x: torch.Tensor, w: torch.Tensor, ep: Epilogue) -> str:
    """K1's ``select_tile`` for contiguous operands of one K4 call, with
    M = C: each expert's (C, K) @ (K, N) is the problem a tile sees."""
    _, c, k = x.shape
    return mm.select_tile(c, w.shape[2], k, x.dtype, ep.glu,
                          x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor, ep: Epilogue,
                         accum_dtype: torch.dtype) -> torch.Tensor:
    """``epilogue(x[e] @ w[e])``: a batched product in ``accum_dtype``,
    then ``apply_epilogue``."""
    return grouped_matmul_ref(x, w, epilogue=ep, accum_dtype=accum_dtype)


def grouped_matmul_cuda(x: torch.Tensor, w: torch.Tensor, ep: Epilogue,
                        rows: Optional[torch.Tensor] = None,
                        max_rows: Optional[int] = None,
                        max_experts: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA kernel on contiguous CUDA tensors, on the tile
    ``tile_for`` names.  ``rows``, ``max_rows``, ``max_experts``: as in
    ``ops.grouped_matmul``, checked there."""
    if w.device != x.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("the CUDA grouped matmul takes contiguous operands")
    if x.dtype not in mm._IN_CODES or w.dtype != x.dtype:
        raise NotImplementedError(
            f"the CUDA grouped matmul takes float32, float16, bfloat16 or "
            f"int8 operands of one dtype, got {x.dtype} x {w.dtype}")
    if ep.out_dtype not in mm._OUT_CODES:
        raise NotImplementedError(f"out_dtype {ep.out_dtype} is not one of "
                                  f"{sorted(map(str, mm._OUT_CODES))}")
    e, c, k = x.shape
    n = w.shape[2]
    if ep.glu and n % 2:
        raise ValueError(f"GLU needs an even N, got {n}")
    n_out = n // 2 if ep.glu else n
    out = torch.empty((e, c, n_out), dtype=ep.out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    vec = 16 // x.element_size()
    vec_b = mm._aligned(w, n, vec) and (not ep.glu or n_out % vec == 0)
    tile = tile_for(x, w, ep)
    head = (mm._IN_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
            out.data_ptr(), e, c, n, k, int(ep.glu))
    tail = (rows.data_ptr() if rows is not None else None, float(ep.softcap),
            ACTIVATION_IDS[ep.activation], int(ep.trivial),
            mm._OUT_CODES[ep.out_dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    ws = None
    if tile == "decode":
        mr = c if max_rows is None else min(c, max_rows)
        groups = e if max_experts is None else min(e, max_experts)
        splits, k_split = mm.decode_split(n_out, k, max(groups, 1))
        if splits > 1:
            ws = torch.empty((splits, e, c, n), device=x.device,
                             dtype=torch.int32 if x.dtype == torch.int8
                             else torch.float32)
        err = _decode_launcher()(*head, int(vec_b), mr, splits, k_split,
                                 ws.data_ptr() if ws is not None else None,
                                 *tail)
    elif tile == "tc":
        err = _tc_launcher()(*head, *tail)
    else:
        err = _launcher()(*head, int(mm._aligned(x, k, vec)), int(vec_b),
                          *tail)
    if err != 0:
        raise RuntimeError(f"grouped_matmul kernel launch failed ({tile} "
                           f"tile): CUDA error {err}")
    return out
