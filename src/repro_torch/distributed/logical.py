"""Logical-axis sharding rules (MaxText-style) + activation constraints.

Models annotate activations with *logical* axes ("batch", "seq", "heads",
"mlp", "vocab", ...).  A rules context maps logical axes to mesh axes;
``spec_for`` keeps a mapping only when its mesh axes exist and the
dimension divides by their size (gemma2-2b's 8 heads on a 16-way model
axis fall back to replication — the divisibility-aware fallback).

The reference returns ``PartitionSpec``s and ``NamedSharding``s; here a
spec is the tuple of its entries (``==`` to ``tuple(P)`` of the
reference for the same shape, axes and mesh), and a ``NamedSharding``
pairs it with its mesh and gives the DTensor placements.  Eager torch has
no sharding hint: ``constrain`` leaves a plain tensor as it is and
redistributes a DTensor.  Under a mesh this process is a rank of, the
models run on the rank's shards instead (``tensor_parallel``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Union

import torch

from repro_torch.launch.mesh import Mesh

AxisSpec = Union[str, "tuple[str, ...]", None]

#: default mapping; pod is folded into the data dimension of the batch.
#: "embed" -> "data" is FSDP/ZeRO-3: parameters (and optimizer moments)
#: shard their non-TP dimension over the data axis.
DEFAULT_RULES: "dict[str, AxisSpec]" = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_shard": "data",          # sequence parallelism (long-context)
    "heads": "model",
    "kv_heads": "model",
    "embed": "data",              # FSDP axis
    "mlp": "model",
    "mlp_expert": None,
    "vocab": "model",
    "experts": "model",
    "audio_ctx": None,
}

_ACTIVE: "list[list]" = []        # [mesh, merged rules, placement]


@contextlib.contextmanager
def use_rules(mesh: Optional[Mesh], rules: Optional[dict] = None):
    if mesh is None:
        yield
        return
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    merged = {k: v for k, v in merged.items() if v is not None}
    # the third slot caches this entry's ``tensor_parallel.Placement``
    _ACTIVE.append([mesh, merged, None])
    try:
        yield
    finally:
        _ACTIVE.pop()


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE[-1][0] if _ACTIVE else None


def _axis_size(mesh: Mesh, ax: AxisSpec) -> int:
    if ax is None:
        return 1
    if isinstance(ax, str):
        ax = (ax,)
    return math.prod(mesh.shape[a] for a in ax)


def spec_for(shape, logical_axes) -> Optional[tuple]:
    """The spec of ``shape`` under the active rules, one entry a dim
    (None = inactive)."""
    if not _ACTIVE:
        return None
    mesh, rules, _ = _ACTIVE[-1]
    used: set = set()
    parts = []
    for dim, lax_name in zip(shape, logical_axes):
        ax = rules.get(lax_name) if lax_name else None
        if ax is not None:
            names = (ax,) if isinstance(ax, str) else tuple(ax)
            # Keep only axes present in this mesh (e.g. "pod" is absent on
            # the single-pod mesh) and not already used by another dim.
            names = tuple(n for n in names
                          if n in mesh.shape and n not in used)
            if names and dim % _axis_size(mesh, names) == 0:
                used.update(names)
                parts.append(names if len(names) > 1 else names[0])
                continue
        parts.append(None)
    return tuple(parts)


class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""

    def __init__(self, mesh: Mesh, spec: tuple):
        self.mesh, self.spec = mesh, tuple(spec)

    @property
    def placements(self) -> tuple:
        """DTensor placements, one a mesh axis: ``Shard(d)`` where dim d
        of the spec names the axis, else ``Replicate()``.  A dim over
        several axes (``("pod", "data")``) is split over them in mesh
        order, major first, as JAX splits it."""
        from torch.distributed.tensor import Replicate, Shard
        out = {}
        for d, entry in enumerate(self.spec):
            names = (entry,) if isinstance(entry, str) else entry or ()
            order = [self.mesh.axis_names.index(n) for n in names]
            if order != sorted(order):
                raise NotImplementedError(
                    f"dim {d} of {self.spec} names mesh axes out of mesh "
                    "order")
            out.update({n: Shard(d) for n in names})
        return tuple(out.get(n, Replicate()) for n in self.mesh.axis_names)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec})"


def constrain(x: torch.Tensor, logical_axes) -> torch.Tensor:
    """A DTensor redistributed to the active rules' placements; anything
    else, and everything with no rules active, as it is."""
    spec = spec_for(x.shape, logical_axes)
    if spec is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh = _ACTIVE[-1][0]
    return x.redistribute(mesh.device_mesh,
                          NamedSharding(mesh, spec).placements)


def sharding_for(shape, logical_axes) -> Optional[NamedSharding]:
    spec = spec_for(shape, logical_axes)
    if spec is None:
        return None
    return NamedSharding(_ACTIVE[-1][0], spec)
