"""Naive per-token scan oracle for RWKV-6 WKV (also the decode step)."""

from __future__ import annotations

import torch


def rwkv6_ref(r, k, v, lw, u, initial_state=None):
    """r/k/v/lw: (B, H, T, C); u: (H, C).  Returns (o, final_state).

    o: (B, H, T, C) in r's dtype; state: (B, H, C, C) fp32 with
    S[c_k, c_v] layout.
    """
    b, h, t, c = r.shape
    s = (torch.zeros((b, h, c, c), dtype=torch.float32, device=r.device)
         if initial_state is None else initial_state.float())
    rf, kf, vf, lwf = (x.float() for x in (r, k, v, lw))
    uf = u.float()[None, :, :, None]
    o = torch.empty((b, h, t, c), dtype=torch.float32, device=r.device)
    for i in range(t):
        kv = kf[:, :, i, :, None] * vf[:, :, i, None, :]       # (B, H, C, C)
        s_eff = s + uf * kv
        o[:, :, i] = torch.einsum("bhc,bhcd->bhd", rf[:, :, i], s_eff)
        s = torch.exp(lwf[:, :, i])[..., None] * s + kv
    return o.to(r.dtype), s
