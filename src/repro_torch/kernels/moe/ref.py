"""Plain oracle for the grouped MoE GEMM: one batched product in the
accumulate dtype, then the shared ``apply_epilogue``."""

from __future__ import annotations

import torch

from repro_torch.core.fusion import (NO_OPERANDS, Epilogue, apply_epilogue,
                                     plain_matmul)


def grouped_matmul_ref(x, w, *, epilogue: Epilogue = Epilogue(),
                       accum_dtype=torch.float32):
    """x: (E, C, K); w: (E, K, N) or (E, K, 2, N/2) under GLU."""
    if w.dim() == 4:
        w = w.reshape(w.shape[0], w.shape[1], -1)
    return apply_epilogue(plain_matmul(x, w, accum_dtype), epilogue,
                          NO_OPERANDS)
