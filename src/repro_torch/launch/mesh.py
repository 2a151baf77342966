"""Meshes over the running world, and the world itself.

The reference lays named axes over the devices one JAX controller sees
(``jax.make_mesh``).  The port runs one process a rank under
``torch.distributed``: ``init_world`` joins the world and binds the
rank's card, ``make_mesh`` lays named axes over the world's ranks (a torch
``DeviceMesh``, which holds one process group an axis), and
``abstract_mesh`` carries sizes and names alone (the reference's
``compat_abstract_mesh``), so that the sharding rules can be held without
a world; ``rank_view`` adds one rank's coordinate, so that a step can run
on ``meta`` as that rank runs it.  ``run_world`` spawns the ranks of a world on this host (the
multi-rank tests, ``chip_smoke.py``).

Single pod: 16×16 = 256 ranks (data, model); multi-pod: 2×16×16 with an
explicit "pod" axis that the default rules fold into data parallelism.
Functions, not module-level constants: importing this module touches no
process group and no device.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import sys
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

#: seconds a collective (and a spawned world) may take before it fails
DEFAULT_TIMEOUT = 600.0


class AxisGroup:
    """The group of one axis of a rank view (``rank_view``): its name and
    size, and no process group.  ``distributed.collectives`` records a
    collective over it on ``meta`` tensors and runs nothing."""

    def __init__(self, axis: str, size: int):
        self.axis, self.size = axis, size

    def __repr__(self) -> str:
        return f"AxisGroup({self.axis!r}, {self.size})"


class Mesh:
    """Named axes over ranks, as ``jax.sharding.Mesh`` shows them:
    ``shape`` maps each axis name to its size, in mesh order.
    ``device_mesh`` is the torch ``DeviceMesh`` over the world's first
    ``size`` ranks (row-major), None for an abstract mesh or a rank view
    (``rank_view``: one rank's coordinate, no world)."""

    def __init__(self, shape: "dict[str, int]", device_mesh=None,
                 coordinate: "Optional[tuple[int, ...]]" = None):
        self.shape = dict(shape)
        self.device_mesh = device_mesh
        self._view = None if coordinate is None else tuple(coordinate)

    @property
    def axis_names(self) -> "tuple[str, ...]":
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def _ranks(self):
        if self.device_mesh is None:
            raise ValueError(f"{self!r} is abstract: it has sizes and names "
                             "but no ranks (make_mesh builds one over the "
                             "world)")
        return self.device_mesh

    @property
    def has_rank(self) -> bool:
        """Whether this process is a rank of the mesh: a rank of the world
        inside it, or a rank view.  An abstract mesh has none."""
        if self._view is not None:
            return True
        return (self.device_mesh is not None
                and self.device_mesh.get_coordinate() is not None)

    @property
    def coordinate(self) -> "Optional[tuple[int, ...]]":
        """This rank's place on each axis; None for a rank of the world
        outside the mesh."""
        if self._view is not None:
            return self._view
        c = self._ranks().get_coordinate()
        return None if c is None else tuple(c)

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (``jax.lax.axis_index``)."""
        c = self.coordinate
        if c is None:
            raise ValueError(f"rank {dist.get_rank()} is not in {self!r}")
        return c[self.axis_names.index(axis)]

    def group(self, axis: str):
        """The process group of this rank's line along ``axis`` (an
        ``AxisGroup`` on a rank view)."""
        if self._view is not None:
            return AxisGroup(axis, self.shape[axis])
        return self._ranks().get_group(axis)

    def __repr__(self) -> str:
        if self._view is not None:
            return f"Mesh({self.shape}, rank view at {self._view})"
        kind = "abstract " if self.device_mesh is None else ""
        return f"{kind}Mesh({self.shape})"


def abstract_mesh(sizes, names) -> Mesh:
    """Sizes and names without ranks (the reference's
    ``compat_abstract_mesh``): enough for ``logical.spec_for`` and the
    ``sharding`` rules."""
    sizes, names = tuple(sizes), tuple(names)
    if len(sizes) != len(names):
        raise ValueError(f"sizes {sizes} and names {names} differ in length")
    return Mesh(dict(zip(names, sizes)))


def rank_view(sizes, names, coordinate=None) -> Mesh:
    """One rank of a mesh of ``sizes`` over ``names``, without a world:
    its coordinate (rank 0's by default) and an ``AxisGroup`` an axis.
    Run on ``meta`` tensors, a step under it is that rank's program, its
    collectives recorded and not run: how the dry run counts one rank of
    a 256-rank mesh in one process."""
    mesh = abstract_mesh(sizes, names)
    coordinate = tuple(coordinate or (0,) * len(mesh.shape))
    if len(coordinate) != len(mesh.shape) or not all(
            0 <= c < n for c, n in zip(coordinate, mesh.shape.values())):
        raise ValueError(f"coordinate {coordinate} is not on {mesh!r}")
    return Mesh(mesh.shape, coordinate=coordinate)


@dataclasses.dataclass(frozen=True)
class World:
    """The running world as ``init_world`` joined it."""
    rank: int
    size: int
    backend: str
    device: torch.device
    reason: str                  # why this backend
    #: every rank on this host's one card: ``distributed.same_card``
    #: moves the bytes of the gloo collectives on CUDA tensors
    one_card: bool = False


_WORLD: Optional[World] = None


def init_world(device=None, *, rank: Optional[int] = None,
               world_size: Optional[int] = None,
               init_method: Optional[str] = None,
               timeout: float = DEFAULT_TIMEOUT) -> World:
    """Join the world (``torch.distributed.init_process_group``) and bind
    this rank's card.

    ``rank`` and ``world_size`` default to ``RANK`` and ``WORLD_SIZE``;
    ``init_method`` to ``env://`` (``MASTER_ADDR``/``MASTER_PORT``).  The
    ranks run on the card unless ``device="cpu"``; without a card that is
    an error, not a fallback.  The backend follows from the devices:
    ``nccl`` when each rank of the host has a card of its own, ``gloo`` on
    the CPU and when ranks share a card (NCCL refuses two ranks on one
    device).  The choice is printed to standard error; a failure raises,
    and no other backend is tried.
    """
    global _WORLD
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                  else world_size)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_size = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    dev = torch.device(device) if device is not None else torch.device("cuda")
    kw = {}
    if dev.type == "cpu":
        backend, reason = "gloo", "CPU tensors"
    elif dev.type != "cuda":
        raise ValueError(f"init_world runs ranks on 'cuda' or 'cpu', got "
                         f"{dev}")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the ranks run on the GPU "
                               "(pass device='cpu' to run them on the CPU)")
        cards = torch.cuda.device_count()
        if dev.index is None:
            dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
        if cards >= local_size:
            backend, reason = "nccl", "a card a rank"
            kw["device_id"] = dev
        else:
            backend, reason = "gloo", (
                f"{local_size} ranks share {cards} card(s); NCCL takes one "
                "rank a card")
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout), **kw)
    one_card = (backend == "gloo" and dev.type == "cuda"
                and torch.cuda.device_count() == 1
                and local_size == world_size)
    if one_card:
        reason += "; collectives on the card"
    _WORLD = World(rank, world_size, backend, dev, reason, one_card)
    print(f"init_world: rank {rank} of {world_size}, backend {backend} "
          f"({reason}), device {dev}", file=sys.stderr, flush=True)
    return _WORLD


def make_mesh(shape, names) -> Mesh:
    """A mesh of ``shape`` with axes ``names`` over the world's first
    ``prod(shape)`` ranks, row-major (``jax.make_mesh`` over the first
    devices).  Every rank of the world calls it (each axis's groups are
    made collectively); a rank outside the mesh gets coordinate None.
    Raises without a world, or with fewer ranks than the mesh needs."""
    shape, names = tuple(shape), tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"shape {shape} and names {names} differ in length")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the world: call init_world "
                           "first")
    n, world = math.prod(shape), dist.get_world_size()
    if n > world:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the world has "
                         f"{world}")
    from torch.distributed.device_mesh import DeviceMesh
    # the device of the world init_world joined, else the backend's
    device_type = (_WORLD.device.type if _WORLD is not None else
                   "cuda" if dist.get_backend() == "nccl" else "cpu")
    dm = DeviceMesh(device_type, torch.arange(n).view(shape),
                    mesh_dim_names=names)
    return Mesh(dict(zip(names, shape)), dm)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh(model: int = 1) -> Mesh:
    """Debug mesh over the whole world: (world // model, model) over
    (data, model)."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs the world: call "
                           "init_world first")
    n = dist.get_world_size()
    model = min(model, n)
    return make_mesh((n // model, model), ("data", "model"))


def _rank_main(local_rank: int, fn: Callable, nprocs: int, rendezvous: str,
               device, timeout: float, args: tuple) -> None:
    os.environ["LOCAL_RANK"] = str(local_rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(nprocs)
    world = init_world(device, rank=local_rank, world_size=nprocs,
                       init_method=f"file://{os.path.abspath(rendezvous)}",
                       timeout=timeout)
    try:
        fn(world, *args)
    finally:
        dist.destroy_process_group()


def run_world(fn: Callable, nprocs: int, args: tuple = (), *,
              rendezvous: str, device=None,
              timeout: float = DEFAULT_TIMEOUT) -> None:
    """Spawn ``nprocs`` ranks on this host, each running ``fn(world,
    *args)`` after ``init_world(device)``, and wait for them.

    The ranks meet through the file ``rendezvous`` (removed first if a
    former world left it), so no port is fixed.  ``fn`` must be importable
    by name from its module (``spawn`` start method; a script's
    ``__main__`` is re-imported without running its main block).  Raises
    if a rank fails (the others are ended) or if the world outlives
    ``timeout`` seconds (every rank is killed).
    """
    import torch.multiprocessing as mp
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    ctx = mp.start_processes(
        _rank_main, args=(fn, nprocs, rendezvous, device, timeout, args),
        nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, min(
                1.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"the world of {nprocs} ranks did not "
                                   f"finish within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
