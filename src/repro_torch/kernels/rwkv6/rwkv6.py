"""The chunked RWKV-6 WKV kernel (K6) and its plain versions.

``rwkv6_wkv_cuda`` launches one of K6's two CUDA tiles, the Hopper
counterparts of the reference's Pallas ``rwkv6_kernel``
(``repro/kernels/rwkv6/rwkv6.py``), with an initial and a final state
besides; ``select_tile`` alone decides which:

* ``"tc"`` (``csrc/rwkv6_wkv_sm90.cu``): bf16/fp16 at head size 64 and
  chunk 32 or 64 whose pointers and strides allow 16-byte loads; its
  products run on the tensor cores, with a two-level (16-token) split of
  the chunk, and it reads r, k, v and lw through their strides;
* ``"simt"`` (``csrc/rwkv6_wkv.cu``): the rest (fp32, whose 1e-4
  tolerance operands rounded to 16 bits cannot meet, other head sizes,
  and views it cannot vector-load), on contiguous copies.

``rwkv6_chunked`` is the torch counterpart of the reference's
``rwkv6_chunked_jnp`` (``repro/models/rwkv6.py``): the same chunked
arithmetic in plain tensor ops.  It is the kernel's plain version (the
CPU tests run it, and ``chip_smoke.py`` holds both tiles against it on
the card) and the model's ``torch`` route.  ``rwkv6_chunked_tc`` is the
tensor-core tile's arithmetic (sub-chunk reference points, operands
rounded to 16 bits, the hi/lo state update) in plain ops, for the tests.

r, k, v: (B, H, T, C) in one dtype; lw: (B, H, T, C) fp32 log decay
(<= 0); u: (H, C) fp32 -> (o (B, H, T, C) in r's dtype, final state
(B, H, C, C) fp32, S[c_k, c_v]).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.hlo_cost import tensor_bytes
from repro_torch.kernels import bind_device, launcher, stream

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
CHUNKS = (32, 64)             # chunk lengths the kernel takes
MAX_HEAD = 64                 # largest head size C the kernel takes
SUB = 16                      # the tensor-core tile's sub-chunk length
TC_HEAD = 64                  # the head size the tensor-core tile takes
TILES = ("tc", "simt")
LOAD_BYTES = 16               # the tensor-core tile's vector loads

_fn = None                    # the SIMT tile (rwkv6_wkv.cu)
_tc_fn = None                 # the tensor-core tile (rwkv6_wkv_sm90.cu)

_P, _I = ctypes.c_void_p, ctypes.c_int


def _bind(stem: str, symbol: str, argtypes: list):
    from repro_torch.kernels import build
    fn = getattr(build.load(stem), symbol)
    fn.argtypes = argtypes
    fn.restype = _I
    return fn


def _launcher():
    global _fn
    if _fn is None:
        _fn = _bind("rwkv6_wkv", "rwkv6_wkv_launch",
                    [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                     _P])
    return _fn


def _tc_launcher():
    global _tc_fn
    if _tc_fn is None:
        _tc_fn = _bind("rwkv6_wkv_sm90", "rwkv6_wkv_tc_launch",
                       [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        ctypes.POINTER(ctypes.c_longlong), _P])
    return _tc_fn


def select_tile(dtype: torch.dtype, c: int, chunk: int, aligned: bool,
                strides) -> str:
    """The tile that computes one call: K6's rule.

    ``aligned``: r, k, v and lw start on 16-byte boundaries with unit
    stride along C; ``strides``: their byte strides along B, H and T, of
    the dims longer than 1.  bf16 and fp16 at head size 64 and chunk 32
    or 64 take the tensor-core tile when every stride is a positive whole
    number of 16 bytes, as its vector loads need; fp32 stays off the
    tensor cores (its tolerance is 1e-4, which operands rounded to 16
    bits cannot meet), and it, other head sizes and the views the tile
    cannot vector-load take the SIMT tile.  No tile falls back to
    another: a failed launch raises.
    """
    if (dtype in (torch.bfloat16, torch.float16) and c == TC_HEAD
            and chunk in CHUNKS and aligned
            and all(s > 0 and s % LOAD_BYTES == 0 for s in strides)):
        return "tc"
    return "simt"


def tile_for(r, k, v, lw, *, chunk: int) -> str:
    """``select_tile`` for the r, k, v and lw of one call at ``chunk``."""
    tensors = (r, k, v, lw)
    return select_tile(
        r.dtype, r.shape[-1], chunk,
        all(x.data_ptr() % LOAD_BYTES == 0 and x.stride(-1) == 1
            for x in tensors),
        [s * x.element_size() for x in tensors
         for n, s in zip(x.shape[:3], x.stride()[:3]) if n > 1])


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


def rwkv6_chunked_tc(r, k, v, lw, u, *, chunk: int = 64,
                     initial_state=None, rounding=None):
    """The tensor-core tile's arithmetic (``csrc/rwkv6_wkv_sm90.cu``) in
    plain tensor ops; returns (o, final_state).

    Per chunk, with la the inclusive prefix sum of lw and LA = (0, la)
    (so LA[t] = la_prev[t] and LA[s + 1] = la[s]), the chunk is cut into
    sub-chunks of ``SUB`` tokens:

    * inter-chunk: ``(r * exp(LA[t])) @ S`` in bf16 whichever 16-bit
      ``rounding`` (the state is not bounded, and fp16 ends at 65504),
      each operand split into hi + lo and the lo-lo product dropped;
    * intra-chunk, sub-chunk i against j < i: ``(r_t exp(LA[t] - ref_i))
      . (k_s exp(ref_i - LA[s + 1]))`` with ref_i = LA[SUB i], the la of
      the last token before sub-chunk i, both factors rounded to
      ``rounding``; on the diagonal (s < t in one sub-chunk) the
      pairwise exp in fp32; the scores P rounded to ``rounding``
      before ``P @ V``;
    * the bonus ``((r * u) . k) v`` in fp32;
    * the state: ``exp(la_L) S + hi^T V + lo^T V``, where hi + lo is
      ``k * exp(la_L - la)`` split into two values of ``rounding``.

    ``rounding=None`` keeps every operand in fp32: the same
    factorisation, exact up to fp32.  A ragged last chunk is padded with
    lw = 0 and k = 0, as in ``rwkv6_chunked``.
    """
    b, h, t, c = r.shape
    pad = (-t) % chunk
    if pad:
        r, k, v, lw = (F.pad(x, (0, 0, 0, pad)) for x in (r, k, v, lw))
    n = (t + pad) // chunk

    def rnd_to(dtype):
        if rounding is None:
            return lambda x: x
        return lambda x: x.to(dtype).float()
    rnd, rnd_inter = rnd_to(rounding), rnd_to(torch.bfloat16)

    def to_chunks(x):
        return x.float().reshape(b, h, n, chunk, c)

    rc, kc, vc, lwc = map(to_chunks, (r, k, v, lw))
    sub = torch.arange(SUB, device=r.device)
    below = (sub[:, None] > sub[None, :])[..., None]        # s < t
    uf = u.float()[None, :, None, :]
    state = (torch.zeros((b, h, c, c), dtype=torch.float32, device=r.device)
             if initial_state is None else initial_state.float())
    outs = []
    for i in range(n):
        rr, kk, vv, ww = (x[:, :, i] for x in (rc, kc, vc, lwc))
        la_ = torch.cat([torch.zeros_like(ww[:, :, :1]),
                         torch.cumsum(ww, dim=2)], dim=2)   # (b, h, L+1, c)
        lp, la = la_[:, :, :-1], la_[:, :, 1:]
        q = rr * torch.exp(lp)
        q_hi, s_hi = rnd_inter(q), rnd_inter(state)
        o = (q_hi @ s_hi + q_hi @ rnd_inter(state - s_hi)
             + rnd_inter(q - q_hi) @ s_hi)
        p = rr.new_zeros((b, h, chunk, chunk))
        for j in range(chunk // SUB):
            tj = slice(SUB * j, SUB * (j + 1))
            diff = lp[:, :, tj, None, :] - la[:, :, None, tj, :]
            p[:, :, tj, tj] = (
                rr[:, :, tj, None, :] * kk[:, :, None, tj, :]
                * torch.exp(torch.where(below, diff, -torch.inf))).sum(-1)
            if j:
                ref = la_[:, :, SUB * j, None, :]
                a = rnd(rr[:, :, tj] * torch.exp(lp[:, :, tj] - ref))
                kb = rnd(kk[:, :, :SUB * j]
                         * torch.exp(ref - la[:, :, :SUB * j]))
                p[:, :, tj, :SUB * j] = a @ kb.transpose(-1, -2)
        o = o + rnd(p) @ vv
        o = o + (rr * uf * kk).sum(-1, keepdim=True) * vv
        la_last = la[:, :, -1:, :]
        k_hat = kk * torch.exp(la_last - la)
        hi = rnd(k_hat)
        lo = rnd(k_hat - hi)
        state = (torch.exp(la_last[:, :, 0, :])[..., None] * state
                 + hi.transpose(-1, -2) @ vv + lo.transpose(-1, -2) @ vv)
        outs.append(o)
    o = torch.cat(outs, dim=2)[:, :, :t]
    return o.to(r.dtype), state


def launch_cost(r, k, v, lw, u, chunk: int,
                initial_state=None) -> "tuple[float, int]":
    """(FLOPs, bytes) of one call.  FLOPs: the three dots a chunk of the
    reference's ``xla`` route (``rwkv6_chunked_jnp``) makes at this
    chunk L, over T padded to whole chunks: 2·B·H·T'·C·(2C + L).  Bytes:
    r, k, v, lw and u as the launch takes them (lw, u in fp32), the
    initial state, o and the final state."""
    b, h, t, c = r.shape
    padded = -(-t // chunk) * chunk
    state = 4 * b * h * c * c
    return (2.0 * b * h * padded * c * (2 * c + chunk),
            tensor_bytes(r) * 2 + tensor_bytes(k) + tensor_bytes(v)
            + 4 * lw.numel() + 4 * u.numel() + state
            + (state if initial_state is not None else 0))


def rwkv6_wkv_cuda(r, k, v, lw, u, *, chunk: int, initial_state=None):
    """Launch the CUDA kernel on CUDA tensors (on ``meta`` tensors, all
    but the launch), on the tile ``tile_for`` names: (o, final state,
    that tile), or (o, final state, None) where there is nothing to
    launch (no batch or no head)."""
    bind_device(r)
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
    lw = lw.to(torch.float32)
    u = u.to(torch.float32).contiguous()
    s0 = None
    if initial_state is not None:
        s0 = initial_state.to(device=r.device,
                              dtype=torch.float32).contiguous()
    s_out = torch.empty((b, h, c, c), dtype=torch.float32, device=r.device)
    if b * h == 0:
        return torch.empty_like(r), s_out, None
    tile = tile_for(r, k, v, lw, chunk=chunk)
    launch = rwkv6_wkv_tc if tile == "tc" else rwkv6_wkv_simt
    return (launch(r, k, v, lw, u, s0, s_out, chunk=chunk), s_out, tile)


def _check(err: int, tile: str) -> None:
    if err != 0:
        raise RuntimeError(f"rwkv6_wkv kernel launch failed ({tile} tile): "
                           f"CUDA error {err}")


def rwkv6_wkv_tc(r, k, v, lw, u, s0, s_out, *, chunk: int):
    """The tensor-core tile on r, k, v and lw as they lie (no copy); o is
    written in (B, T, H, C) order and returned as its (B, H, T, C) view,
    which is what the model's ``o.transpose(1, 2).reshape(b, t, d)``
    reads without a copy."""
    b, h, t, c = r.shape
    o = torch.empty((b, t, h, c), dtype=r.dtype,
                    device=r.device).transpose(1, 2)
    strides = [s for x in (r, k, v, lw, o) for s in x.stride()[:3]]
    _check(launcher(_tc_launcher, r)(
        _DTYPE_CODES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
        lw.data_ptr(), u.data_ptr(), None if s0 is None else s0.data_ptr(),
        o.data_ptr(), s_out.data_ptr(), b, h, t, chunk,
        (ctypes.c_longlong * 15)(*strides),
        stream(r)), "tc")
    return o


def rwkv6_wkv_simt(r, k, v, lw, u, s0, s_out, *, chunk: int):
    """The SIMT tile, at any of the three dtypes and head sizes up to
    64, on contiguous copies of r, k, v and lw."""
    b, h, t, c = r.shape
    r, k, v, lw = (x.contiguous() for x in (r, k, v, lw))
    o = torch.empty((b, h, t, c), dtype=r.dtype, device=r.device)
    _check(launcher(_launcher, r)(
        _DTYPE_CODES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
        lw.data_ptr(), u.data_ptr(), None if s0 is None else s0.data_ptr(),
        o.data_ptr(), s_out.data_ptr(), b, h, t, c, chunk,
        stream(r)), "simt")
    return o
