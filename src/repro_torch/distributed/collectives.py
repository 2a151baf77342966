"""The port's collectives, in one place.

Every collective of ``distributed/``, ``models/``, ``training/``,
``optim/`` and ``launch/train.py`` goes through these functions.  NCCL
takes CUDA tensors for all of them.  Gloo — the backend of a CPU world
and of ranks that share one card — takes CUDA tensors for
``all_reduce``, ``all_gather`` and ``broadcast`` (fp32, bf16, int32 and
int8, on an H100), but not for point-to-point ``send``/``recv``, where a
CUDA tensor aborts the process: this module stages those through host
copies, and counts each staged op in ``STAGED``, so that a caller can
say which of its collectives crossed the host.  Under gloo
``reduce_scatter`` is an all-reduce of which each rank keeps its chunk:
gloo takes that on CUDA tensors too.  Where every rank shares this
host's one card (``World.one_card``), ``all_gather``, ``all_reduce`` and
``reduce_scatter`` move their bytes on the card instead
(``distributed.same_card``: gloo only passes handles and meets), and a
sum adds the ranks' values in group rank order.  Nothing falls back
silently: a collective that fails raises.  ``group=None`` is the whole
world.

Each records its result's bytes by kind in an active cost counter
(``core.hlo_cost``), as the reference's ``hlo_cost`` sums each
collective's result shape.  The kinds are the reference's HLO names:
``all-reduce``, ``all-gather``, ``reduce-scatter`` and
``collective-permute`` (``exchange``, the point-to-point pass that
``jax.lax.ppermute`` makes), and ``broadcast``, which has no HLO op of
its own: where the port broadcasts (the pipeline's closing step), the
reference all-reduces a masked array of the same shape, so its bytes
stand for ``all-reduce``.  A collective's own copies are not counted as
aten ops (``hlo_cost.quiet``).

On ``meta`` tensors, or over the ``AxisGroup`` of a rank view
(``launch.mesh.rank_view``), a collective needs no process group: it
returns a result of the right shape and records its kind and bytes.
That is how the dry run counts one rank of a 256-rank mesh.

The autograd pairs of tensor parallelism and FSDP (Megatron's ``f`` and
``g``, ZeRO-3's gather) are ``torch.autograd.Function``s over these:

========================  =====================  ======================
function                  forward                backward
========================  =====================  ======================
``copy_to_group``         identity               all-reduce
``reduce_from_group``     all-reduce             identity
``gather_from_group``     all-gather along dim   reduce-scatter
``scatter_to_group``      reduce-scatter         all-gather
``gather_to_whole``       all-gather along dim   the rank's chunk
========================  =====================  ======================

``gather_from_group`` is the FSDP weight gather over the data axes and the
sequence-parallel gather over ``model``; ``scatter_to_group`` the
sequence-parallel reduce-scatter; ``gather_to_whole`` gathers a region's
column shards where every rank then computes the same from them (Megatron's
gather at a column-parallel output), so that each rank's gradient is
already the whole one.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.core import hlo_cost
from repro_torch.core.hlo_cost import tensor_bytes
from repro_torch.distributed import same_card
from repro_torch.launch import mesh
from repro_torch.launch.mesh import AxisGroup

#: op name -> collectives staged through the host since the last reset
STAGED: "dict[str, int]" = {}
_GLOO_TAKES_CUDA = frozenset({"all_reduce", "all_gather", "broadcast"})
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _staged(op: str, t: torch.Tensor, group) -> bool:
    if (t.is_cuda and op not in _GLOO_TAKES_CUDA
            and dist.get_backend(group) == "gloo"):
        STAGED[op] = STAGED.get(op, 0) + 1
        return True
    return False


def _global(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def _on_one_card(t: torch.Tensor) -> bool:
    """Whether ``t``'s collective runs among ranks that share this host's
    one card, its bytes moved on the card (``same_card``)."""
    world = mesh._WORLD
    return t.is_cuda and world is not None and world.one_card


def _reduce(t: torch.Tensor, group, op: str = "sum") -> None:
    if _on_one_card(t):
        with hlo_cost.quiet():
            same_card.all_reduce(t, group, op)
    else:
        dist.all_reduce(t, op=_OPS[op], group=group)


def _recorded_only(t: torch.Tensor, group) -> bool:
    """A collective that runs nothing: on ``meta``, or over a rank view's
    axis."""
    return t.is_meta or isinstance(group, AxisGroup)


def group_size(group) -> int:
    if isinstance(group, AxisGroup):
        return group.size
    return dist.get_world_size(group)


def all_reduce(t: torch.Tensor, group=None, op: str = "sum") -> torch.Tensor:
    """Reduce ``t`` over ``group`` in place (``op``: "sum" or "max");
    returns ``t``."""
    if not _recorded_only(t, group):
        _reduce(t, group, op)
    hlo_cost.collective("all-reduce", tensor_bytes(t))
    return t


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t``, concatenated along ``dim`` in group rank
    order."""
    n = group_size(group)
    with hlo_cost.quiet():
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        if _recorded_only(t, group):
            pass
        elif _on_one_card(t):
            same_card.all_gather(t, parts, group)
        else:
            dist.all_gather(parts, t, group=group)
        out = torch.cat(parts, dim=dim)
    hlo_cost.collective("all-gather", tensor_bytes(out), out)
    return out


def reduce_scatter(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The sum of ``t`` over ``group``, of which this rank keeps its
    chunk along ``dim`` (chunk i to the group's rank i): ``all_gather``'s
    adjoint.  ``t.shape[dim]`` must divide by the group's size."""
    n = group_size(group)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"over {n} ranks")
    size = t.shape[dim] // n
    with hlo_cost.quiet():
        if _recorded_only(t, group):
            out = t.narrow(dim, 0, size).clone(
                memory_format=torch.contiguous_format)
        elif dist.get_backend(group) == "gloo":
            whole = t.clone(memory_format=torch.contiguous_format)
            _reduce(whole, group)
            out = whole.narrow(dim, dist.get_rank(group) * size, size).clone(
                memory_format=torch.contiguous_format)
            del whole
        else:
            moved = t.movedim(dim, 0).contiguous()
            out = moved.new_empty((size,) + moved.shape[1:])
            dist.reduce_scatter_tensor(out, moved, group=group)
            out = out.movedim(0, dim).contiguous()
    hlo_cost.collective("reduce-scatter", tensor_bytes(out), out)
    return out


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``t`` of the group's rank ``src`` on every rank, in place."""
    dist.broadcast(t, src=_global(group, src), group=group)
    hlo_cost.collective("broadcast", tensor_bytes(t))
    return t


def exchange(send: torch.Tensor, recv: torch.Tensor, dst: int, src: int,
             group=None) -> Callable[[], None]:
    """Start passing ``send`` to the group's rank ``dst`` and receiving
    ``recv`` from its rank ``src``; returns the function that waits for
    both.  Work queued between the two (a kernel) overlaps the pass."""
    staged = _staged("send/recv", send, group)
    s, r = ((send.to("cpu"), torch.empty(recv.shape, dtype=recv.dtype))
            if staged else (send.contiguous(), recv))
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, s, _global(group, dst), group),
        dist.P2POp(dist.irecv, r, _global(group, src), group)])
    hlo_cost.collective("collective-permute", tensor_bytes(recv))

    def wait() -> None:
        for w in works:
            w.wait()
        if staged:
            recv.copy_(r)
    return wait


# ---------------------------------------------------------------------------
# The autograd pairs.
# ---------------------------------------------------------------------------

def _reduced(t: torch.Tensor, group) -> torch.Tensor:
    with hlo_cost.quiet():
        t = t.clone(memory_format=torch.contiguous_format)
    return all_reduce(t, group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ScatterToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _GatherToWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        rank = (0 if _recorded_only(g, ctx.group)
                else dist.get_rank(ctx.group))
        return g.narrow(ctx.dim, rank * ctx.size, ctx.size), None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; its gradient all-reduced over ``group`` (the input
    of a region whose ranks each compute a share of what follows)."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; its gradient passed as it is (the
    output of such a region: the ranks' partial sums added)."""
    return _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` along ``dim``; its gradient reduce-scattered
    (a shard gathered where the ranks then use it differently)."""
    return _GatherFromGroup.apply(x, group, dim)


def scatter_to_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the sum of ``x`` over
    ``group``; its gradient all-gathered."""
    return _ScatterToGroup.apply(x, group, dim)


def gather_to_whole(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` along ``dim``; its gradient narrowed to this
    rank's chunk (the ranks compute the same from the whole, so each
    holds the whole gradient)."""
    return _GatherToWhole.apply(x, group, dim)
