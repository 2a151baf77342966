"""Dense-attention oracle with identical mask semantics to the kernel."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, sm_scale: Optional[float] = None,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0, q_start: int = 0):
    """q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D).  fp32 math throughout."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / d ** 0.5
    group = h // hkv
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * sm_scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qpos = q_start + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= (qpos - kpos) < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # fully-masked rows: softmax of all -inf -> uniform; zero them instead.
    p = torch.where(mask.any(dim=-1)[:, None], p, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)
