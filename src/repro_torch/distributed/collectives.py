"""The port's collectives, in one place.

Every collective of ``distributed/``, ``models/moe.py`` and
``optim/compression.py`` goes through these functions.  NCCL takes CUDA
tensors for all of them.  Gloo — the backend of a CPU world and of ranks
that share one card — takes CUDA tensors for ``all_reduce``,
``all_gather`` and ``broadcast`` (fp32, bf16, int32 and int8, on an
H100), but not for point-to-point ``send``/``recv``, where a CUDA tensor
aborts the process: this module stages those through host copies, and
counts each staged op in ``STAGED``, so that a caller can say which of
its collectives crossed the host.  Nothing falls back silently: a
collective that fails raises.  ``group=None`` is the whole world.

Each records its result's bytes by kind in an active cost counter
(``core.hlo_cost``), as the reference's ``hlo_cost`` sums each
collective's result shape.  The kinds are the reference's HLO names:
``all-reduce``, ``all-gather`` and ``collective-permute`` (``exchange``,
the point-to-point pass that ``jax.lax.ppermute`` makes), and
``broadcast``, which has no HLO op of its own: where the port
broadcasts (the pipeline's closing step), the reference all-reduces a
masked array of the same shape, so its bytes stand for ``all-reduce``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.core import hlo_cost
from repro_torch.core.hlo_cost import tensor_bytes

#: op name -> collectives staged through the host since the last reset
STAGED: "dict[str, int]" = {}
_GLOO_TAKES_CUDA = frozenset({"all_reduce", "all_gather", "broadcast"})


def _staged(op: str, t: torch.Tensor, group) -> bool:
    if (t.is_cuda and op not in _GLOO_TAKES_CUDA
            and dist.get_backend(group) == "gloo"):
        STAGED[op] = STAGED.get(op, 0) + 1
        return True
    return False


def _global(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns ``t``."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    hlo_cost.collective("all-reduce", tensor_bytes(t))
    return t


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t``, concatenated along ``dim`` in group rank
    order."""
    t = t.contiguous()
    parts = [torch.empty_like(t)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    hlo_cost.collective("all-gather", tensor_bytes(t) * len(parts))
    return torch.cat(parts, dim=dim)


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
