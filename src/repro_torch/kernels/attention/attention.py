"""The flash-attention kernel (K2) and its plain version.

``flash_attention_cuda`` launches ``csrc/flash_attention.cu``, the Hopper
counterpart of the reference's Pallas ``flash_attention_kernel``
(``repro/kernels/attention/attention.py``).  ``flash_attention_plain``
computes the same function densely with plain tensor ops: the CPU tests
run it, and ``chip_smoke.py`` holds the kernel against it on the card.

q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D) -> (B, H, Sq, D) in q's dtype.
Query head h reads KV head h // (H / Hkv); query row i sits at position
``q_start + i``; a key is seen if it is inside ``Sk``, not after the
query (causal) and fewer than ``window`` positions before it.  A query
that sees no key gives 0.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels.attention.ref import attention_ref

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_HEAD_DIMS = (32, 64, 128, 256)  # head dims the kernel is instantiated for

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        from repro_torch.kernels import build
        fn = build.load("flash_attention").flash_attention_launch
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [i, i, p, p, p, p, i, i, i, i, i,
                       ctypes.POINTER(ctypes.c_longlong), f, i, i, f, i, i,
                       p]
        fn.restype = i
        _fn = fn
    return _fn


def flash_attention_plain(q, k, v, *, sm_scale: float, causal: bool,
                          window: int, softcap: float, q_start: int):
    """Dense masked softmax in fp32: the kernel's function, unblocked."""
    return attention_ref(q, k, v, sm_scale=sm_scale, causal=causal,
                         window=window, softcap=softcap, q_start=q_start)


def flash_attention_cuda(q, k, v, *, sm_scale: float, causal: bool,
                         window: int, softcap: float, q_start: int):
    """Launch the CUDA kernel on CUDA tensors."""
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODES or not (q.dtype == k.dtype == v.dtype):
        raise NotImplementedError(
            f"the CUDA flash attention takes float32, float16 or bfloat16 "
            f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dk = next((x for x in _HEAD_DIMS if x >= d), None)
    if dk is None:
        raise NotImplementedError(f"head_dim {d} > {_HEAD_DIMS[-1]}")
    if dk != d:      # zero columns change no score and give 0 outputs
        q, k, v = (F.pad(x, (0, dk - d)) for x in (q, k, v))
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    o = torch.empty((b, h, sq, dk), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o[..., :d]
    tensors = (q, k, v, o)
    strides = [s for x in tensors for s in x.stride()[:3]]
    elems = 16 // q.element_size()
    vec = all(x.data_ptr() % 16 == 0 for x in tensors) and all(
        s % elems == 0 for s in strides)
    err = _launcher()(
        _DTYPE_CODES[q.dtype], dk, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), b, h, hkv, sq, sk, (ctypes.c_longlong * 12)(*strides),
        float(sm_scale), int(causal), int(window), float(softcap),
        int(q_start), int(vec),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    return o if dk == d else o[..., :d]
