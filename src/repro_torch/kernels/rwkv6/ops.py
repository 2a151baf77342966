"""Wrapper of the chunked RWKV-6 WKV kernel (K6).

CUDA tensors go to the kernel, on the tile ``select_tile`` picks; each
tile masks the ragged last chunk itself, so unlike the reference wrapper
nothing is padded, and there is no ``interpret``.  It takes an
initial state and returns the final one, which the reference's kernel
does not.
"""

from __future__ import annotations

from repro_torch.core import hlo_cost
from repro_torch.kernels import refuse_autograd
from repro_torch.kernels.rwkv6.rwkv6 import (TILES, launch_cost,
                                             rwkv6_chunked, rwkv6_wkv_cuda)


def rwkv6_scan(r, k, v, lw, u, *, chunk: int = 32, initial_state=None):
    """r/k/v/lw: (B, H, T, C); u: (H, C) -> (o (B, H, T, C), state
    (B, H, C, C) fp32).

    CUDA tensors launch the kernel on the tile ``select_tile`` picks
    (and count the launch, where there was one, in
    ``rwkv6_scan.launches`` and ``rwkv6_scan.launches_by_tile``) or
    raise; ``meta`` tensors take the same path but for the launch; CPU
    tensors run the plain version.  A cost counter (``core.hlo_cost``)
    counts each as one launch (``launch_cost``).  It has no backward: a
    call that autograd would track raises (``kernels.refuse_autograd``).
    """
    if r.dim() != 4:
        raise ValueError(f"r must be (B, H, T, C), got {tuple(r.shape)}")
    refuse_autograd("rwkv6_scan (K6)", "queue 1, item I", r, k, v, lw, u,
                    initial_state)
    kw = dict(chunk=chunk, initial_state=initial_state)
    if r.is_cuda or r.is_meta:
        o, state, tile = rwkv6_wkv_cuda(r, k, v, lw, u, **kw)
        if tile is not None:
            if r.is_cuda:
                rwkv6_scan.launches += 1
                rwkv6_scan.launches_by_tile[tile] += 1
            hlo_cost.count("rwkv6_wkv", launch_cost, r, k, v, lw, u, chunk,
                           initial_state)
        return o, state
    with hlo_cost.counted("rwkv6_wkv", launch_cost, r, k, v, lw, u, chunk,
                          initial_state):
        return rwkv6_chunked(r, k, v, lw, u, **kw)


rwkv6_scan.launches = 0
rwkv6_scan.launches_by_tile = dict.fromkeys(TILES, 0)
