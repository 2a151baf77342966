"""Collectives among ranks that share one card, on the card.

Gloo is the backend of ranks that share a card (NCCL takes one rank a
card), and gloo moves a CUDA tensor through the host: a copy to host
memory, a ring over TCP, a copy back, at about a gigabyte a second for
the full-width weights that FSDP gathers at every step.  Ranks on one
card can instead read each other's memory.  Each rank holds, for each
group it meets in, a staging buffer of two halves of ``STAGE_BYTES``
(``cuMemAlloc``, outside PyTorch's caching allocator, so that no rank's
``max_memory_allocated`` changes), exported over CUDA IPC and mapped
once by each peer.  A collective moves its tensor in rounds of at most
``STAGE_BYTES``: each rank copies its chunk into the half of the round,
the ranks meet once over gloo (an all-gather of each buffer's 64-byte
handle, which says that every chunk is written), and each reads its
peers' chunks on the card.  The halves alternate round by round within
the group, so a rank writes a half again only two rounds later, after
every peer has met it once more and so has finished reading that half.

* ``all_gather``: every rank's tensor, in group rank order, copied into
  tensors of its own (allocated as gloo's path allocates them, so that a
  rank's peak memory is the same on either path).
* ``all_reduce``: each element is the sum (or max) of the ranks' values
  taken in group rank order, ``((x0 + x1) + x2) + ...`` in the tensor's
  dtype, on every rank alike.  Gloo's ring adds in another order, so an
  fp32 sum of more than two ranks may differ from gloo's in its last
  bits; with two ranks the sum is the same (addition commutes).

Only the bytes move here: what each collective computes and what it
records in the cost counter are ``collectives``'s.  Nothing falls back:
a driver call that fails raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.distributed as dist

#: bytes of a half of a rank's staging buffer, the largest chunk a round
#: moves
STAGE_BYTES = 64 << 20

_HANDLE_BYTES = 64
_LAZY_ENABLE_PEER_ACCESS = 1


class _IpcHandle(ctypes.Structure):
    _fields_ = [("reserved", ctypes.c_ubyte * _HANDLE_BYTES)]


class _Memory:
    """A device pointer as ``torch.as_tensor`` takes it
    (``__cuda_array_interface__``): ``nbytes`` bytes at ``ptr``."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 3, "strides": None}


_DRIVER: Optional[ctypes.CDLL] = None
#: the group's global ranks -> this rank's buffer (both halves), handle
_OWN: "dict[tuple[int, ...], tuple[torch.Tensor, bytes]]" = {}
#: the group's global ranks -> rounds it has moved
_ROUNDS: "dict[tuple[int, ...], int]" = {}
#: a peer's handle -> its buffer, mapped
_PEERS: "dict[bytes, torch.Tensor]" = {}


def _driver() -> ctypes.CDLL:
    global _DRIVER
    if _DRIVER is None:
        lib = ctypes.CDLL("libcuda.so.1")
        lib.cuCtxGetCurrent.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
        lib.cuMemAlloc_v2.argtypes = [ctypes.POINTER(ctypes.c_uint64),
                                      ctypes.c_size_t]
        lib.cuIpcGetMemHandle.argtypes = [ctypes.POINTER(_IpcHandle),
                                          ctypes.c_uint64]
        lib.cuIpcOpenMemHandle_v2.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), _IpcHandle, ctypes.c_uint]
        _DRIVER = lib
    return _DRIVER


def _check(rc: int, call: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{call} failed: CUDA driver error {rc}")


def _bound() -> ctypes.CDLL:
    """The driver, with this thread bound to the card's primary context
    (a runtime call binds it; autograd's device thread may not have made
    one yet)."""
    torch.cuda.current_stream().synchronize()
    lib = _driver()
    ctx = ctypes.c_void_p()
    _check(lib.cuCtxGetCurrent(ctypes.byref(ctx)), "cuCtxGetCurrent")
    if not ctx.value:
        raise RuntimeError("no current CUDA context on this thread")
    return lib


def _own(members: "tuple[int, ...]") -> "tuple[torch.Tensor, bytes]":
    """This rank's staging buffer for the group of ``members`` (a uint8
    tensor of both halves) and its handle."""
    if members not in _OWN:
        lib = _bound()
        ptr = ctypes.c_uint64()
        _check(lib.cuMemAlloc_v2(ctypes.byref(ptr), 2 * STAGE_BYTES),
               "cuMemAlloc")
        handle = _IpcHandle()
        _check(lib.cuIpcGetMemHandle(ctypes.byref(handle), ptr.value),
               "cuIpcGetMemHandle")
        buf = torch.as_tensor(_Memory(ptr.value, 2 * STAGE_BYTES),
                              device="cuda")
        _OWN[members] = (buf, bytes(handle))
    return _OWN[members]


def _peer(handle: bytes) -> torch.Tensor:
    """A peer's staging buffer, mapped once."""
    if handle not in _PEERS:
        lib = _bound()
        ptr = ctypes.c_uint64()
        h = _IpcHandle.from_buffer_copy(handle)
        _check(lib.cuIpcOpenMemHandle_v2(ctypes.byref(ptr), h,
                                         _LAZY_ENABLE_PEER_ACCESS),
               "cuIpcOpenMemHandle")
        _PEERS[handle] = torch.as_tensor(
            _Memory(ptr.value, 2 * STAGE_BYTES), device="cuda")
    return _PEERS[handle]


def _sync() -> None:
    """Every stream of this rank: its copies into its buffer are written
    and its reads of its peers' are done."""
    torch.cuda.synchronize()


def _rounds(flat: torch.Tensor, group):
    """For each chunk of ``flat`` (a contiguous uint8 view of this rank's
    tensor): its byte range and every member's bytes of that range, in
    group rank order (this rank's staged copy too), valid until this
    rank's next round in the group."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    members = tuple(i if group is None else dist.get_global_rank(group, i)
                    for i in range(n))
    buf, handle = _own(members)
    mine = torch.frombuffer(bytearray(handle), dtype=torch.uint8)
    for a in range(0, flat.numel(), STAGE_BYTES):
        b = min(a + STAGE_BYTES, flat.numel())
        k = _ROUNDS.get(members, 0)
        _ROUNDS[members] = k + 1
        lo = (k % 2) * STAGE_BYTES
        buf[lo:lo + b - a].copy_(flat[a:b])
        _sync()                 # also: this rank's reads of round k - 1
        handles = [torch.empty_like(mine) for _ in range(n)]
        dist.all_gather(handles, mine, group=group)
        yield a, b, [buf[lo:lo + b - a] if i == me else
                     _peer(handles[i].numpy().tobytes())[lo:lo + b - a]
                     for i in range(n)]


def _flat(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes, outside autograd and its version counter, as gloo's
    collectives write a tensor."""
    if not t.is_contiguous():
        raise ValueError("a collective among ranks on one card takes "
                         "contiguous tensors")
    return t.data.view(-1).view(torch.uint8)


def all_gather(t: torch.Tensor, parts: "list[torch.Tensor]",
               group=None) -> None:
    """Every member's ``t`` into ``parts`` (each like ``t``, in group
    rank order), as ``dist.all_gather(parts, t, group)``."""
    if t.numel() == 0:
        return
    flats = [_flat(p) for p in parts]
    for a, b, views in _rounds(_flat(t), group):
        for out, v in zip(flats, views):
            out[a:b].copy_(v)


def all_reduce(t: torch.Tensor, group=None, op: str = "sum") -> None:
    """``t`` reduced over ``group`` in place, as ``dist.all_reduce``:
    each element the members' values combined in group rank order."""
    if t.numel() == 0:
        return
    flat = _flat(t)
    for a, b, views in _rounds(flat, group):
        acc = flat[a:b].view(t.dtype)
        acc.copy_(views[0].view(t.dtype))
        for v in views[1:]:
            if op == "sum":
                acc.add_(v.view(t.dtype))
            else:
                torch.maximum(acc, v.view(t.dtype), out=acc)
