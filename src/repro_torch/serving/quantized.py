"""W8A8 inference path — the paper's int8 pipeline as a composable layer.

The paper evaluates all three models in 8-bit with SmoothQuant-O1
(§5.1).  This module is that pipeline on top of ``cute_matmul``:

    weights:      offline per-output-channel absmax int8 (+ fp32 scale),
                  optionally SmoothQuant-migrated by per-in-channel s;
    activations:  dynamic per-row absmax int8 (the vector-unit prologue
                  of Fig. 5): the row-quantiser kernel K3 on the
                  ``"kernel"`` route, its plain oracle on ``"torch"``;
    matmul:       int8×int8→int32 (the fused-matmul kernel K1 on the
                  ``"kernel"`` route);
    epilogue:     dequant scales + bias + activation fused (Table 1's
                  BiasType + the ``scale_a``/``scale_b`` operands).

``W8A8Linear.from_float`` is the offline step; ``__call__`` is the online
step: the smoothing division, one quantisation, one ``cute_matmul``.
The reference quantises activations with its jnp oracle on every route;
the port's ``"kernel"`` route runs K3, which computes the same function
bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.fusion import Epilogue, EpilogueOperands, cute_matmul
from repro_torch.core.task import BiasType
from repro_torch.kernels.quant.ref import (quantize_colwise_ref,
                                           quantize_rowwise_ref,
                                           smoothquant_migrate)


@dataclasses.dataclass
class W8A8Linear:
    """Quantized linear layer: y = act(deq(q(x/s) @ Wq) + b)."""

    w_q: torch.Tensor                    # (K, N) int8
    w_scale: torch.Tensor                # (N,) fp32
    smooth: Optional[torch.Tensor]       # (K,) fp32 per-in-channel divisor
    bias: Optional[torch.Tensor]         # (N,) fp32

    @classmethod
    def from_float(cls, w, bias=None, act_absmax=None, alpha: float = 0.5):
        """Offline quantization; pass calibration ``act_absmax`` (K,) to
        enable SmoothQuant migration (O1)."""
        smooth = None
        w = w.float()
        if act_absmax is not None:
            smooth = smoothquant_migrate(act_absmax, w.abs().amax(1), alpha)
            w = w * smooth[:, None]
        q, scale = quantize_colwise_ref(w)
        return cls(w_q=q, w_scale=scale, smooth=smooth, bias=bias)

    def __call__(self, x, *, activation: str = "none",
                 out_dtype=torch.bfloat16, backend: Optional[str] = None):
        """``backend`` routes the quantiser and the matmul together
        (``None``: the process-wide default of ``repro_torch.backend``)."""
        if backend is None:
            from repro_torch.backend import matmul_backend_string
            backend = matmul_backend_string()
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).float()
        if self.smooth is not None:
            x2 = x2 / self.smooth
        if backend == "kernel":
            from repro_torch.kernels.quant.ops import quantize_rowwise
            x_q, x_scale = quantize_rowwise(x2)
        else:
            x_q, x_scale = quantize_rowwise_ref(x2)
        ep = Epilogue(
            bias_type=BiasType.ROW if self.bias is not None else
            BiasType.ZERO,
            activation=activation, has_scale_a=True, has_scale_b=True,
            out_dtype=out_dtype)
        y = cute_matmul(x_q, self.w_q, epilogue=ep,
                        operands=EpilogueOperands(
                            bias=self.bias, scale_a=x_scale,
                            scale_b=self.w_scale),
                        backend=backend)
        return y.reshape(*lead, y.shape[-1])


def quantize_mlp(wi, wo, x_calib):
    """Quantize a SwiGLU MLP pair with activation calibration."""
    lin_in = W8A8Linear.from_float(
        wi, act_absmax=x_calib.reshape(-1, x_calib.shape[-1]).abs().amax(0))
    # Hidden-activation calibration from the calibration batch itself.
    half = wi.shape[1] // 2
    h = F.silu(x_calib @ wi[:, :half]) * (x_calib @ wi[:, half:])
    lin_out = W8A8Linear.from_float(
        wo, act_absmax=h.reshape(-1, h.shape[-1]).abs().amax(0))
    return lin_in, lin_out
