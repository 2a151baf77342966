"""Carry parameters across from the reference package.

The reference's ``transformer.init`` pytree (``embedding``, ``ln_final``,
``lm_head`` and ``layers``, a tuple of per-group dicts whose leaves are
stacked on a leading layer axis, with a ``moe`` subtree in MoE blocks)
has the same structure as the port's params.  Pass it leaf by leaf as
numpy arrays (``np.asarray`` of each leaf); nothing here imports JAX.

``torch.from_numpy`` rejects the ``ml_dtypes`` bfloat16 and float8
dtypes, so those go through an unsigned-integer view of the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.serving.quantized import W8A8Linear

_BIT_VIEWS = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}


def to_torch(x) -> torch.Tensor:
    """One array (numpy, or anything ``np.asarray`` takes) as a CPU
    tensor with the same dtype and bits."""
    a = np.ascontiguousarray(np.asarray(x))
    view = _BIT_VIEWS.get(a.dtype.name)
    if view is not None:
        return torch.from_numpy(a.view(view[0]).copy()).view(view[1])
    return torch.from_numpy(a.copy())


def params_from_jax(tree):
    """The reference's params pytree (dicts, tuples, lists of arrays) as
    the port's params, leaf by leaf, on the CPU."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_from_jax(v) for v in tree)
    return to_torch(tree)


def w8a8_from_jax(lin):
    """The reference's ``W8A8Linear`` (its four arrays, each passed
    through ``np.asarray``; ``smooth`` and ``bias`` may be None) as the
    port's, on the CPU."""
    def opt(x):
        return None if x is None else to_torch(x)
    return W8A8Linear(w_q=to_torch(lin.w_q), w_scale=to_torch(lin.w_scale),
                      smooth=opt(lin.smooth), bias=opt(lin.bias))
