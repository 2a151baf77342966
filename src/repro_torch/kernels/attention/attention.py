"""The flash-attention kernel (K2) and its plain version.

``flash_attention_cuda`` launches one of K2's two CUDA tiles, the Hopper
counterparts of the reference's Pallas ``flash_attention_kernel``
(``repro/kernels/attention/attention.py``); ``select_tile`` alone decides
which:

* ``"tc"`` (``csrc/flash_attention_sm90.cu``): bf16/fp16 at head_dim 64,
  128 or 256 whose pointers and strides TMA can take; wgmma on the
  tensor cores, q, k and v loaded by TMA through their own strides;
* ``"simt"`` (``csrc/flash_attention.cu``): everything else (fp32,
  int8, other head dims, which it zero-pads, and views TMA refuses).

``flash_attention_plain`` computes the same function densely with plain
tensor ops: the CPU tests run it, and ``chip_smoke.py`` holds each tile
against it on the card.

q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D) -> (B, H, Sq, D) in q's dtype
(int8: the fp32 result truncated toward zero, as the reference's
``astype``).
Query head h reads KV head h // (H / Hkv); query row i sits at position
``q_start + i``; a key is seen if it is inside ``Sk``, not after the
query (causal) and fewer than ``window`` positions before it.  A query
that sees no key gives 0.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.hlo_cost import tensor_bytes
from repro_torch.kernels import bind_device, launcher, stream
from repro_torch.kernels.attention.ref import attention_ref

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2,
                torch.int8: 3}
_HEAD_DIMS = (32, 64, 128, 256)  # head dims the SIMT tile is built for
TC_HEAD_DIMS = (64, 128, 256)    # head dims the tensor-core tile is built for
TILES = ("tc", "simt")
TMA_ALIGN = 8            # 16-bit elements in TMA's 16-byte stride unit

_fn = None               # the SIMT tile (flash_attention.cu)
_tc_fn = None            # the tensor-core tile (flash_attention_sm90.cu)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)


def _bind(stem: str, symbol: str, argtypes: list):
    from repro_torch.kernels import build
    fn = getattr(build.load(stem), symbol)
    fn.argtypes = argtypes
    fn.restype = _I
    return fn


def _launcher():
    global _fn
    if _fn is None:
        _fn = _bind("flash_attention", "flash_attention_launch",
                    [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _STRIDES,
                     _F, _I, _I, _F, _I, _I, _P])
    return _fn


def _tc_launcher():
    global _tc_fn
    if _tc_fn is None:
        _tc_fn = _bind("flash_attention_sm90", "flash_attention_tc_launch",
                       [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _STRIDES,
                        _F, _I, _I, _F, _I, _P])
    return _tc_fn


def select_tile(dtype: torch.dtype, d: int, aligned: bool,
                strides) -> str:
    """The tile that computes one call: K2's rule.

    ``aligned``: q, k and v start on 16-byte boundaries; ``strides``:
    their element strides along B, H and S, of the dims longer than 1
    (TMA never steps along the others).  bf16 and fp16 at head_dim 64,
    128 or 256 take the tensor-core tile when every stride is a positive
    whole 16-byte unit, as TMA needs; fp32 stays off the tensor cores
    (its parity tolerance is 1e-3, and P would be rounded), and it,
    int8, the head dims the SIMT tile pads and the views TMA refuses take
    the SIMT tile.  No tile falls back to another: a failed launch raises.
    """
    if (dtype in (torch.bfloat16, torch.float16) and d in TC_HEAD_DIMS
            and aligned and all(s > 0 and s % TMA_ALIGN == 0
                                for s in strides)):
        return "tc"
    return "simt"


def tile_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """``select_tile`` for the q, k and v of one call."""
    tensors = (q, k, v)
    return select_tile(
        q.dtype, q.shape[-1], all(x.data_ptr() % 16 == 0 for x in tensors),
        [s for x in tensors for n, s in zip(x.shape[:3], x.stride()[:3])
         if n > 1])


def launch_cost(q, k, v, chunk: int = 0) -> "tuple[float, int]":
    """(FLOPs, bytes) of one call.  FLOPs: the two dots of the
    reference's ``xla`` route (``attention_xla_chunked``) for the same
    call, 4·B·H·Sq·Sk'·D, with Sk' the keys padded to whole KV blocks of
    ``chunk`` (or Sk if shorter), since that route computes every block,
    masked or not; the model passes its ``attn_chunk``, and ``chunk`` 0
    counts the keys unpadded.  Bytes: q, k, v and the output."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    chunk = min(chunk, sk) or sk
    padded = -(-sk // chunk) * chunk if chunk else 0
    return (4.0 * b * h * sq * padded * d,
            2 * tensor_bytes(q) + tensor_bytes(k) + tensor_bytes(v))


def flash_attention_plain(q, k, v, *, sm_scale: float, causal: bool,
                          window: int, softcap: float, q_start: int):
    """Dense masked softmax in fp32: the kernel's function, unblocked."""
    return attention_ref(q, k, v, sm_scale=sm_scale, causal=causal,
                         window=window, softcap=softcap, q_start=q_start)


def flash_attention_cuda(q, k, v, *, sm_scale: float, causal: bool,
                         window: int, softcap: float, q_start: int):
    """Launch the CUDA kernel on CUDA tensors with unit stride along the
    head dim (on ``meta`` tensors, all but the launch), on the tile
    ``tile_for`` names: (output, that tile), or
    (output, None) where there is nothing to launch (an empty output, or
    no key, which gives 0)."""
    bind_device(q)
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODES or not (q.dtype == k.dtype == v.dtype):
        raise NotImplementedError(
            f"the CUDA flash attention takes float32, float16, bfloat16 or "
            f"int8 q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
            f"{v.dtype}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("the CUDA flash attention takes q, k, v with unit "
                         "stride along the head dim")
    if q.numel() == 0 or k.shape[2] == 0:
        return q.new_zeros(q.shape), None
    tile = tile_for(q, k, v)
    launch = flash_attention_tc if tile == "tc" else flash_attention_simt
    return launch(q, k, v, sm_scale=sm_scale, causal=causal, window=window,
                  softcap=softcap, q_start=q_start), tile


def flash_attention_tc(q, k, v, *, sm_scale: float, causal: bool,
                       window: int, softcap: float, q_start: int):
    """The tensor-core tile on q, k, v as they lie (non-empty, with a
    key): no copy, no padding.  Strides of dims of length 1 are passed as
    D (any whole 16-byte unit serves a dim TMA never steps along)."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    o = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    strides = [s if n > 1 else d for x in (q, k, v, o)
               for n, s in zip(x.shape[:3], x.stride()[:3])]
    err = launcher(_tc_launcher, q)(
        _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), b, h, hkv, sq, sk, (ctypes.c_longlong * 12)(*strides),
        float(sm_scale), int(causal), int(window), float(softcap),
        int(q_start), stream(q))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed (tc "
                           f"tile): CUDA error {err}")
    return o


def flash_attention_simt(q, k, v, *, sm_scale: float, causal: bool,
                         window: int, softcap: float, q_start: int):
    """The SIMT tile, at any of the four dtypes, on a non-empty q and a
    key; head dims below 256 that it is not built for are zero-padded."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dk = next((x for x in _HEAD_DIMS if x >= d), None)
    if dk is None:
        raise NotImplementedError(f"head_dim {d} > {_HEAD_DIMS[-1]}")
    if dk != d:      # zero columns change no score and give 0 outputs
        q, k, v = (F.pad(x, (0, dk - d)) for x in (q, k, v))
    o = torch.empty((b, h, sq, dk), dtype=q.dtype, device=q.device)
    tensors = (q, k, v, o)
    strides = [s for x in tensors for s in x.stride()[:3]]
    elems = 16 // q.element_size()
    vec = all(x.data_ptr() % 16 == 0 for x in tensors) and all(
        s % elems == 0 for s in strides)
    err = launcher(_launcher, q)(
        _DTYPE_CODES[q.dtype], dk, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), b, h, hkv, sq, sk, (ctypes.c_longlong * 12)(*strides),
        float(sm_scale), int(causal), int(window), float(softcap),
        int(q_start), int(vec),
        stream(q))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed (simt "
                           f"tile): CUDA error {err}")
    return o if dk == d else o[..., :d]
