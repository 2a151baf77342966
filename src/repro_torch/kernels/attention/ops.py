"""Wrapper of the flash-attention kernel (K2), plus decode attention.

``flash_attention`` sends CUDA tensors to the kernel, on the tile
``select_tile`` picks (each masks ragged lengths itself, so nothing is
padded to blocks), and CPU tensors to its plain version.
``decode_attention`` (one query against a long cache) is plain tensor
code, as in the reference.  ``decode_attention_partial`` and
``decode_attention_merge`` split it over shares of the cache's positions
(sequence-parallel decode attention, ``models/transformer.py``): each
share gives its running max, sum of exponentials and unnormalised P·V,
and the merge rescales and adds them.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import hlo_cost
from repro_torch.kernels import refuse_autograd
from repro_torch.kernels.attention.attention import (TILES,
                                                     flash_attention_cuda,
                                                     flash_attention_plain,
                                                     launch_cost)


def _pad_axis(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    """Zero-pad ``x`` along ``axis`` up to a multiple of ``mult``."""
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * (x.ndim - axis % x.ndim)
    widths[-1] = pad
    return torch.nn.functional.pad(x, widths)


def flash_attention(q, k, v, *, sm_scale: Optional[float] = None,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_start: int = 0,
                    cost_chunk: int = 0):
    """q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D) -> (B, H, Sq, D).

    CUDA tensors launch the kernel on the tile ``select_tile`` picks
    (and count the launch, where there was one, in
    ``flash_attention.launches`` and in ``flash_attention.launches_by_tile``)
    or raise; ``meta`` tensors take the same path but for the launch;
    CPU tensors run the plain version.  A cost counter
    (``core.hlo_cost``) counts each as one launch (``launch_cost``, its
    keys padded to whole blocks of ``cost_chunk`` as the reference's
    ``xla`` route pads them to the model's ``attn_chunk``).  It
    has no backward: a call that autograd would track raises
    (``kernels.refuse_autograd``).
    """
    h, d = q.shape[1], q.shape[-1]
    hkv = k.shape[1]
    if h % hkv:
        raise ValueError(f"GQA needs H % Hkv == 0, got {h}, {hkv}")
    refuse_autograd("flash_attention (K2)", "queue 1, item F", q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / d ** 0.5
    kw = dict(sm_scale=sm_scale, causal=causal, window=window,
              softcap=softcap, q_start=q_start)
    if q.is_cuda or q.is_meta:
        q, k, v = (x if x.stride(-1) == 1 else x.contiguous()
                   for x in (q, k, v))
        out, tile = flash_attention_cuda(q, k, v, **kw)
        if tile is not None:
            if q.is_cuda:
                flash_attention.launches += 1
                flash_attention.launches_by_tile[tile] += 1
            hlo_cost.count("flash_attention", launch_cost, q, k, v,
                           cost_chunk)
        return out
    with hlo_cost.counted("flash_attention", launch_cost, q, k, v,
                          cost_chunk):
        return flash_attention_plain(q, k, v, **kw)


flash_attention.launches = 0
flash_attention.launches_by_tile = dict.fromkeys(TILES, 0)


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     sm_scale: Optional[float] = None, window: int = 0,
                     softcap: float = 0.0):
    """Single-token decode: q (B, H, 1, D) vs cache (B, Hkv, S, D).

    ``cache_len`` (int or (B,)) marks the valid prefix; the new token
    is assumed already written at position cache_len - 1.
    """
    b, h, _, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / d ** 0.5
    group = h // hkv
    qe = q.reshape(b, hkv, group, d).float()
    scores = torch.einsum("bngd,bnsd->bngs", qe, k_cache.float()) * sm_scale
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    pos = torch.arange(s, device=q.device)
    cache_len = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = pos[None, :] < cache_len                          # (B, S)
    if window > 0:
        valid &= pos[None, :] >= (cache_len - window)
    scores = torch.where(valid[:, None, None, :], scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngs,bnsd->bngd", p, v_cache.float())
    return out.reshape(b, h, 1, d).to(q.dtype)


def decode_attention_partial(q, k_cache, v_cache, cache_len, *,
                             start: int = 0,
                             sm_scale: Optional[float] = None,
                             window: int = 0, softcap: float = 0.0):
    """``decode_attention`` over a share of the cache: ``k_cache`` and
    ``v_cache`` hold positions ``[start, start + S)``, masked as the
    whole cache's are (``pos < cache_len``, and ``pos >= cache_len -
    window`` with a window), in absolute positions.  Returns fp32 (m, l,
    acc): the row max of the masked scores, the sum of their
    exponentials and P·V, unnormalised, shaped (B, Hkv, group, 1), (B,
    Hkv, group, 1) and (B, Hkv, group, D).  A share whose every position
    is masked gives l = 0 and acc = 0 (and m = -1e30)."""
    b, h, _, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / d ** 0.5
    qe = q.reshape(b, hkv, h // hkv, d).float()
    scores = torch.einsum("bngd,bnsd->bngs", qe, k_cache.float()) * sm_scale
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    pos = start + torch.arange(s, device=q.device)
    cache_len = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = pos[None, :] < cache_len                          # (B, S)
    if window > 0:
        valid &= pos[None, :] >= (cache_len - window)
    valid = valid[:, None, None, :]
    scores = torch.where(valid, scores, -1e30)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), 0.0)
    acc = torch.einsum("bngs,bnsd->bngd", p, v_cache.float())
    return m, p.sum(dim=-1, keepdim=True), acc


def decode_attention_merge(m, l, acc, *, reduce_max, reduce_sum, dtype):
    """The attention output (B, H, 1, D) in ``dtype`` from the shares'
    (m, l, acc) (``decode_attention_partial``): the max over the shares
    (``reduce_max``), each share's sum and P·V rescaled to it and added
    (``reduce_sum``, once over both).  The shares lie on the ranks of a
    group (all-reduces), or along a leading dim of one process's
    tensors (``amax`` and ``sum`` over it)."""
    top = reduce_max(m)
    scale = torch.exp(m - top)
    both = reduce_sum(torch.cat([l * scale, acc * scale], dim=-1))
    l, acc = both[..., :1], both[..., 1:]
    out = acc / torch.where(l == 0.0, 1.0, l)
    b, hkv, group, d = out.shape
    return out.reshape(b, hkv * group, 1, d).to(dtype)
