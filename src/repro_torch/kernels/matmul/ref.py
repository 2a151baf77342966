"""Plain oracle for the fused matmul kernel.

Deliberately boring: one matmul in the accumulate dtype plus the shared
``apply_epilogue``.
"""

from __future__ import annotations

import torch

from repro_torch.core.fusion import (Epilogue, EpilogueOperands,
                                     apply_epilogue, plain_matmul)


def fused_matmul_ref(a, b, *, epilogue: Epilogue = Epilogue(),
                     operands: EpilogueOperands = EpilogueOperands(),
                     accum_dtype=torch.float32):
    """a: (M, K); b: (K, N), or (K, 2, N/2) when epilogue.glu."""
    if b.dim() == 3:
        b = b.reshape(b.shape[0], -1)
    return apply_epilogue(plain_matmul(a, b, accum_dtype), epilogue,
                          operands)
