"""Plain oracle for int8 quantisation and SmoothQuant scale migration.

Divisions by a constant divide by a tensor of that constant: on CUDA,
PyTorch computes ``tensor / python_float`` as a multiplication by the
reciprocal, which is not the IEEE quotient the reference and the kernel
compute, and flips a quantised value where it lands near a .5 tie.
"""

from __future__ import annotations

import torch


def _scale_of(absmax: torch.Tensor) -> torch.Tensor:
    """absmax / 127, or 1 where absmax is 0 (IEEE division)."""
    return torch.where(absmax == 0.0, 1.0,
                       absmax / torch.full_like(absmax, 127.0))


def quantize_rowwise_ref(x):
    """x: (..., M, K) -> (q int8, scale f32 (..., M))."""
    xf = x.float()
    scale = _scale_of(xf.abs().amax(dim=-1, keepdim=True))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def quantize_colwise_ref(w):
    """Static per-output-channel weight quant: w (K, N) -> (q, scale (N,))."""
    wf = w.float()
    scale = _scale_of(wf.abs().amax(dim=0, keepdim=True))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale[0]


def smoothquant_migrate(x_absmax, w_absmax, alpha: float = 0.5):
    """SmoothQuant §4: s_j = max|X_j|^α / max|W_j|^(1-α) (per in-channel).

    Activations are divided by ``s``, weights multiplied — difficulty
    migrates from activations to weights.  O1 applies this offline.

    Agrees with the reference to an ulp or two, not bit for bit: XLA's
    ``pow`` on the CPU is not correctly rounded (and under ``jit`` it
    becomes ``sqrt(a) * rsqrt(b)`` with XLA's own ``rsqrt``), and no
    torch op reproduces its last bit.
    """
    s = torch.pow(torch.clamp(x_absmax, min=1e-5), alpha) / torch.pow(
        torch.clamp(w_absmax, min=1e-5), 1.0 - alpha)
    return torch.clamp(s, min=1e-5)
