"""The chunked RWKV-6 WKV kernel (K6) and its plain version.

``rwkv6_wkv_cuda`` launches ``csrc/rwkv6_wkv.cu``, the Hopper counterpart
of the reference's Pallas ``rwkv6_kernel`` (``repro/kernels/rwkv6/
rwkv6.py``), with an initial and a final state besides.
``rwkv6_chunked`` is the torch counterpart of the reference's
``rwkv6_chunked_jnp`` (``repro/models/rwkv6.py``): the same chunked
arithmetic in plain tensor ops.  It is the kernel's plain version (the
CPU tests run it, and ``chip_smoke.py`` holds the kernel against it on
the card) and the model's ``torch`` route.

r, k, v: (B, H, T, C) in one dtype; lw: (B, H, T, C) fp32 log decay
(<= 0); u: (H, C) fp32 -> (o (B, H, T, C) in r's dtype, final state
(B, H, C, C) fp32, S[c_k, c_v]).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
CHUNKS = (32, 64)             # chunk lengths the kernel takes
MAX_HEAD = 64                 # largest head size C the kernel takes

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        from repro_torch.kernels import build
        fn = build.load("rwkv6_wkv").rwkv6_wkv_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = i
        _fn = fn
    return _fn


def rwkv6_chunked(r, k, v, lw, u, *, chunk: int = 64, initial_state=None):
    """The chunked WKV with plain tensor ops; returns (o, final_state).

    A ragged last chunk is padded with lw = 0 and k = 0, which leaves the
    state untouched.
    """
    b, h, t, c = r.shape
    pad = (-t) % chunk
    if pad:
        r, k, v, lw = (F.pad(x, (0, 0, 0, pad)) for x in (r, k, v, lw))
    n = (t + pad) // chunk

    def to_chunks(x):
        return x.float().reshape(b, h, n, chunk, c)

    rc, kc, vc, lwc = map(to_chunks, (r, k, v, lw))
    mask = (torch.arange(chunk, device=r.device)[:, None]
            > torch.arange(chunk, device=r.device)[None, :])
    uf = u.float()[None, :, None, :]
    state = (torch.zeros((b, h, c, c), dtype=torch.float32, device=r.device)
             if initial_state is None else initial_state.float())
    outs = []
    for i in range(n):
        rr, kk, vv, ww = (x[:, :, i] for x in (rc, kc, vc, lwc))
        la = torch.cumsum(ww, dim=2)
        la_prev = la - ww
        o = torch.einsum("bhlc,bhcd->bhld", rr * torch.exp(la_prev), state)
        diff = la_prev[:, :, :, None, :] - la[:, :, None, :, :]
        pair = (rr[:, :, :, None, :] * kk[:, :, None, :, :]
                * torch.exp(torch.where(mask[..., None], diff, -1e30)))
        o = o + torch.einsum("bhls,bhsd->bhld", pair.sum(-1), vv)
        o = o + (rr * uf * kk).sum(-1, keepdim=True) * vv
        la_last = la[:, :, -1:, :]
        k_scaled = kk * torch.exp(la_last - la)
        state = (torch.exp(la_last[:, :, 0, :])[..., None] * state
                 + torch.einsum("bhlc,bhld->bhcd", k_scaled, vv))
        outs.append(o)
    o = torch.cat(outs, dim=2)[:, :, :t]
    return o.to(r.dtype), state


def rwkv6_wkv_cuda(r, k, v, lw, u, *, chunk: int, initial_state=None):
    """Launch the CUDA kernel on CUDA tensors."""
    if r.dtype not in _DTYPE_CODES or not (r.dtype == k.dtype == v.dtype):
        raise NotImplementedError(
            f"the CUDA WKV takes float32, float16 or bfloat16 r, k, v of "
            f"one dtype, got {r.dtype}, {k.dtype}, {v.dtype}")
    if not (r.device == k.device == v.device == lw.device == u.device):
        raise ValueError("r, k, v, lw and u must be on one device")
    b, h, t, c = r.shape
    if chunk not in CHUNKS or c > MAX_HEAD:
        raise NotImplementedError(f"the CUDA WKV takes chunk in {CHUNKS} and "
                                  f"head size <= {MAX_HEAD}, got {chunk}, "
                                  f"{c}")
    r, k, v = (x.contiguous() for x in (r, k, v))
    lw = lw.to(torch.float32).contiguous()
    u = u.to(torch.float32).contiguous()
    s0 = None
    if initial_state is not None:
        s0 = initial_state.to(device=r.device,
                              dtype=torch.float32).contiguous()
    o = torch.empty((b, h, t, c), dtype=r.dtype, device=r.device)
    s_out = torch.empty((b, h, c, c), dtype=torch.float32, device=r.device)
    if b * h == 0:
        return o, s_out
    err = _launcher()(
        _DTYPE_CODES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
        lw.data_ptr(), u.data_ptr(), None if s0 is None else s0.data_ptr(),
        o.data_ptr(), s_out.data_ptr(), b, h, t, c, chunk,
        torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_wkv kernel launch failed: CUDA error "
                           f"{err}")
    return o, s_out
