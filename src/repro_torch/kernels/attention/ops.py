"""Wrapper of the flash-attention kernel (K2), plus decode attention.

``flash_attention`` sends CUDA tensors to the kernel (which masks ragged
lengths itself, so nothing is padded to blocks) and CPU tensors to its
plain version.  ``decode_attention`` (one query against a long cache) is
plain tensor code, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.attention.attention import (flash_attention_cuda,
                                                     flash_attention_plain)


def flash_attention(q, k, v, *, sm_scale: Optional[float] = None,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_start: int = 0):
    """q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D) -> (B, H, Sq, D).

    CUDA tensors launch the kernel (and count the launch in
    ``flash_attention.launches``) or raise; CPU tensors run the plain
    version.
    """
    h, d = q.shape[1], q.shape[-1]
    hkv = k.shape[1]
    if h % hkv:
        raise ValueError(f"GQA needs H % Hkv == 0, got {h}, {hkv}")
    if sm_scale is None:
        sm_scale = 1.0 / d ** 0.5
    kw = dict(sm_scale=sm_scale, causal=causal, window=window,
              softcap=softcap, q_start=q_start)
    if q.is_cuda:
        out = flash_attention_cuda(q, k, v, **kw)
        flash_attention.launches += 1
        return out
    return flash_attention_plain(q, k, v, **kw)


flash_attention.launches = 0


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
