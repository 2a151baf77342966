"""The RG-LRU scan kernel (K5) and its plain version.

``rglru_scan_cuda`` launches ``csrc/rglru_scan.cu``, the Hopper
counterpart of the reference's Pallas ``rglru_kernel``
(``repro/kernels/rglru/rglru.py``).  That kernel starts from a zero
state; this one takes an initial state and returns the final one, which
is the whole of ``rglru_ref``'s function.  ``rglru_scan_plain`` computes
it with plain tensor ops: the CPU tests run it, and ``chip_smoke.py``
holds the kernel against it on the card.

log_a, x: (B, T, C) float32 -> (h (B, T, C) float32, h_T (B, C) float32).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.hlo_cost import tensor_bytes
from repro_torch.kernels import bind_device, launcher, stream
from repro_torch.kernels.rglru.ref import rglru_ref

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        from repro_torch.kernels import build
        fn = build.load("rglru_scan").rglru_scan_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, p]
        fn.restype = i
        _fn = fn
    return _fn


def launch_cost(log_a, x, initial_state=None) -> "tuple[float, int]":
    """(FLOPs, bytes) of one call: no dot (0 FLOPs, as the reference's
    ``xla`` route has none); log_a, x and h0 in, h and h_T out, fp32."""
    b, t, c = x.shape
    h0 = 4 * b * c if initial_state is not None else 0
    return 0.0, 4 * (3 * b * t * c + b * c) + h0


def rglru_scan_plain(log_a, x, initial_state=None):
    """The recurrence step by step in fp32 tensor ops."""
    return rglru_ref(log_a.float(), x.float(), initial_state)


def rglru_scan_cuda(log_a, x, initial_state=None):
    """Launch the CUDA kernel on CUDA tensors (on ``meta`` tensors, all
    but the launch)."""
    bind_device(x)
    if log_a.device != x.device:
        raise ValueError(f"log_a and x on {log_a.device} and {x.device}")
    if log_a.dtype != torch.float32 or x.dtype != torch.float32:
        raise NotImplementedError(f"the CUDA RG-LRU scan takes float32 "
                                  f"log_a and x, got {log_a.dtype}, "
                                  f"{x.dtype}")
    b, t, c = x.shape
    if log_a.shape != x.shape:
        raise ValueError(f"log_a {tuple(log_a.shape)} and x "
                         f"{tuple(x.shape)} differ")
    h0 = None
    if initial_state is not None:
        if tuple(initial_state.shape) != (b, c):
            raise ValueError(f"initial_state must be ({b}, {c}), got "
                             f"{tuple(initial_state.shape)}")
        h0 = initial_state.to(device=x.device,
                              dtype=torch.float32).contiguous()
    log_a, x = log_a.contiguous(), x.contiguous()
    h = torch.empty((b, t, c), dtype=torch.float32, device=x.device)
    h_last = (torch.zeros((b, c), dtype=torch.float32, device=x.device)
              if h0 is None else h0.clone())
    if h.numel() == 0:
        return h, h_last
    err = launcher(_launcher, x)(log_a.data_ptr(), x.data_ptr(),
                      None if h0 is None else h0.data_ptr(), h.data_ptr(),
                      h_last.data_ptr(), b, t, c,
                      stream(x))
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error "
                           f"{err}")
    return h, h_last
