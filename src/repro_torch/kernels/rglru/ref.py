"""Sequential oracle for the RG-LRU recurrence (also the decode step)."""

from __future__ import annotations

import torch


def rglru_ref(log_a, x, initial_state=None):
    """log_a, x: (B, T, C) -> (h_seq (B, T, C), final_state (B, C)).

    ``h_t = exp(la_t) * h_{t-1} + sqrt(-expm1(2 la_t)) * x_t`` in fp32 from
    ``initial_state`` (zeros if None); ``h_seq`` comes back in x's dtype.
    """
    b, t, c = x.shape
    la = log_a.float()
    a = torch.exp(la)
    gated = torch.sqrt(-torch.expm1(2.0 * la)) * x.float()
    h = (torch.zeros((b, c), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    hs = torch.empty((b, t, c), dtype=torch.float32, device=x.device)
    for i in range(t):
        h = a[:, i] * h + gated[:, i]
        hs[:, i] = h
    return hs.to(x.dtype), h


def rglru_decode_step(state, log_a, x):
    """One-token step: state (B, C), log_a/x (B, C) -> (out, new_state)."""
    la = log_a.float()
    new = torch.exp(la) * state + torch.sqrt(-torch.expm1(2.0 * la)) * \
        x.float()
    return new.to(x.dtype), new
