"""A step's cost, counted as the step runs: the port's counterpart of the
reference's ``hlo_cost`` (which walks compiled HLO text).

Torch has no HLO.  ``counting()`` runs a step under a
``TorchDispatchMode`` that sees every aten op the dispatcher runs, on any
device, ``meta`` included (a dry run: shapes, no memory, no kernel).  The
kernels K1–K6 are ctypes launches the dispatcher never sees (K1 under
autograd runs inside the op ``repro_torch::fused_matmul``, which the
counter sees but counts only as a result to hold): each wrapper records
its own launch while a counter is active (``count``),
and on CPU tensors records its plain version as that launch, its aten
ops uncounted (``counted``), so that one call costs the same on every
device.  With no counter active a wrapper's hook is one global check.

The conventions follow the reference's, so that the two read alike:

* **FLOPs**: ``torch.utils.flop_counter``'s formulas for the aten ops it
  knows (mm, addmm, bmm, baddbmm, convolutions, attention), as the
  reference counts dots and convolutions only.  A kernel's FLOPs are the
  dots of the reference's ``xla`` route for the same call (its formula
  sits beside the kernel).
* **bytes**: an aten op's tensor operands plus its results, each tensor
  once (an in-place op's result is its operand).  Views and allocations
  count 0; a gather (``index``, ``embedding``) counts twice its result
  and an indexed write (``index_put_``) twice its values, as the
  reference counts its slices and dynamic-update-slices.  A kernel
  launch counts its operands plus its results: one pass over HBM.  K1's
  op (under autograd) counts as its launch alone: the copies its body
  makes (a transposed operand made contiguous, an epilogue operand made
  fp32), counted as aten ops on the untracked path, are not seen.
* **collective bytes**: result-shape bytes by kind, recorded by
  ``distributed/collectives.py`` (the dispatch mode leaves c10d ops to
  it, and a collective's own copies and concatenations are not counted
  as aten ops, so that a step counts alike on ``meta``, gloo and NCCL).
* **unparsed_loops** is always 0: Python loops run; nothing is parsed.
* **temp_bytes** (no HLO counterpart; the dry run's ``memory``): the
  high-water mark of live storages that the step created (intermediates
  and results, not its arguments), each freed when its storage dies
  (``weakref.finalize`` on the storage: a view, and a tensor autograd
  saves for the backward, keep it alive).
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

_aten = torch.ops.aten
#: ops that move no data: allocations and views the schema does not mark
_FREE = frozenset({
    _aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
    _aten.new_empty_strided, _aten._unsafe_view, _aten.detach,
    _aten.alias, _aten.lift_fresh})
_GATHER = frozenset({_aten.index, _aten.index_select, _aten.embedding,
                     _aten.gather})
_INDEXED_WRITE = frozenset({_aten.index_put_, _aten.index_put,
                            _aten._index_put_impl_})
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")
#: the port's own ops, whose bodies record their kernel launches
_KERNEL_NAMESPACE = "repro_torch"


@dataclasses.dataclass
class HloCost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    per_collective: dict = dataclasses.field(default_factory=dict)
    unparsed_loops: int = 0
    #: kernel name -> {"calls", "flops", "bytes"} of its launches
    kernels: dict = dataclasses.field(default_factory=dict)
    #: aten op name -> {"calls", "flops", "bytes"}
    ops: dict = dataclasses.field(default_factory=dict)
    temp_bytes: int = 0


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _add(table: dict, name: str, flops: float, nbytes: float) -> None:
    row = table.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
    row["calls"] += 1
    row["flops"] += flops
    row["bytes"] += nbytes


class CostCounter(TorchDispatchMode):
    """Counts every aten op it sees into ``cost`` (an ``HloCost``); the
    kernel wrappers and the collectives add theirs through ``kernel`` and
    ``collective``."""

    def __init__(self):
        super().__init__()
        self.cost = HloCost()
        self.quiet = 0          # > 0 while a kernel's plain version runs
        self._live = 0

    # -- what the wrappers and collectives record ------------------------
    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        _add(self.cost.kernels, name, flops, nbytes)
        self.cost.flops += flops
        self.cost.bytes += nbytes

    def collective(self, kind: str, nbytes: float) -> None:
        c = self.cost
        c.collective_bytes += nbytes
        c.per_collective[kind] = c.per_collective.get(kind, 0.0) + nbytes

    # -- aten ops ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.quiet or func.namespace in _COLLECTIVE_NAMESPACES:
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if func.namespace == _KERNEL_NAMESPACE:
            self._track(ins, outs)
            return out
        packet = func.overloadpacket
        flops = 0.0
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
        if func.is_view or packet in _FREE:
            nbytes = 0
        elif packet in _GATHER:
            nbytes = 2 * sum(map(tensor_bytes, outs))
        elif packet in _INDEXED_WRITE:
            nbytes = 2 * tensor_bytes(args[2])
        else:
            seen = {}
            for t in ins + outs:
                seen[id(t)] = t
            nbytes = sum(map(tensor_bytes, seen.values()))
        _add(self.cost.ops, str(packet), flops, nbytes)
        self.cost.flops += flops
        self.cost.bytes += nbytes
        if not func.is_view:
            self._track(ins, outs)
        return out

    def _track(self, ins, outs) -> None:
        """Add each result on a storage no operand holds to the live
        bytes until that storage dies."""
        held = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            if st._cdata in held:
                continue
            held.add(st._cdata)
            n = st.nbytes()
            self._live += n
            self.cost.temp_bytes = max(self.cost.temp_bytes, self._live)
            # the storage, not the tensor: autograd saves an op's output
            # as a new tensor on the same storage, so the result's tensor
            # can die while its storage lives on until the backward
            weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self._live -= n


#: the counter in use, read by the kernel wrappers and the collectives
ACTIVE: Optional[CostCounter] = None


@contextlib.contextmanager
def counting():
    """Count everything run inside; yields the ``CostCounter`` (its
    ``cost`` is complete when the block ends).  Counters do not nest."""
    global ACTIVE
    if ACTIVE is not None:
        raise RuntimeError("a cost counter is already active")
    counter = CostCounter()
    ACTIVE = counter
    try:
        with counter:
            yield counter
    finally:
        ACTIVE = None


def analyze(fn, *args, **kwargs) -> HloCost:
    """The cost of ``fn(*args, **kwargs)``, run once under a counter."""
    with counting() as counter:
        fn(*args, **kwargs)
    return counter.cost


def count(name: str, cost_fn, *args) -> None:
    """Record one launch of kernel ``name``, costing ``cost_fn(*args)``
    = (flops, bytes), in the active counter; nothing without one."""
    if ACTIVE is not None:
        ACTIVE.kernel(name, *cost_fn(*args))


@contextlib.contextmanager
def counted(name: str, cost_fn, *args):
    """Run the block, kernel ``name``'s plain version, as one launch of
    the kernel (``count``): its own aten ops are not counted."""
    counter = ACTIVE
    if counter is None:
        yield
        return
    counter.kernel(name, *cost_fn(*args))
    counter.quiet += 1
    try:
        yield
    finally:
        counter.quiet -= 1


def collective(kind: str, nbytes: float, result=None) -> None:
    """Record a collective of ``kind`` whose result holds ``nbytes``; its
    ``result`` tensor, where given, counts in ``temp_bytes`` while its
    storage lives."""
    if ACTIVE is not None:
        ACTIVE.collective(kind, nbytes)
        if result is not None:
            ACTIVE._track([], [result])


@contextlib.contextmanager
def quiet():
    """Count none of the aten ops run inside (a collective's own copies,
    which differ between backends and devices)."""
    counter = ACTIVE
    if counter is None:
        yield
        return
    counter.quiet += 1
    try:
        yield
    finally:
        counter.quiet -= 1
