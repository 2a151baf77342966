"""Fault-tolerant checkpointing: atomic, async, keep-N.

Layout (one directory per step), the reference's::

    <root>/step_000123/
        index.json          # leaf paths, shapes, dtypes, extra state
        0000.npy … NNNN.npy # one array per leaf

Leaves are numbered in JAX's tree order (``core.tree``: sorted dict keys,
then sequence index) and their paths spelt as the reference spells them,
so a checkpoint written by either package restores in the other.  A
bf16 leaf is stored as the reference stores it: raw 2-byte elements
under the ``.npy`` descr ``'<V2'`` (``ml_dtypes``' bfloat16), with
``"bfloat16"`` in ``index.json``; the port writes and reads those bytes
through a uint16 view, since it does not depend on ``ml_dtypes``.

Guarantees:
  * **atomic** — written to ``step_..._tmp`` then ``os.rename``d; readers
    never observe partial checkpoints, and a crash mid-save leaves the
    previous step intact (restart-safety).
  * **async** — ``save_async`` copies the leaves to host memory on the
    caller's thread, then writes on a background thread so the training
    loop overlaps I/O with compute (checkpoint stall ≈ device→host copy).
  * **keep-N** — old steps garbage-collected after a successful save.

``restore`` loads each leaf whole, onto a device, and places it on a mesh
when given shardings (``distributed.sharding.apply_shardings``): a
checkpoint is mesh-agnostic, so it restores onto any mesh (elastic
restore).  A state held as each rank's shards is saved whole: every rank
calls ``save``/``save_async`` with ``whole``, which gathers one leaf at a
time (``distributed.sharding.gather_params``), and the ``writer`` alone
(rank 0) copies it to the host and writes.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import tree

_BF16 = "bfloat16"


def _to_numpy(x) -> "tuple[np.ndarray, str]":
    """(host array, dtype name) of a leaf; a copy, so that later in-place
    updates of the leaf do not reach a pending write.  bf16 as its bits."""
    t = torch.as_tensor(x).detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).to("cpu", copy=True).numpy(), _BF16
    a = t.to("cpu", copy=True).numpy()
    return a, str(a.dtype)


def _save_npy(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != _BF16:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _load_leaf(path: str, dtype: str, device) -> torch.Tensor:
    arr = np.load(path)
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3, writer: bool = True):
        self.root = root
        self.keep = keep
        self.writer = writer
        self._thread: Optional[threading.Thread] = None
        os.makedirs(root, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Any, extra: Optional[dict] = None,
             whole=None):
        self.wait()
        snap = self._snapshot(state, whole)
        if self.writer:
            self._write(step, snap, extra or {})

    def save_async(self, step: int, state: Any,
                   extra: Optional[dict] = None, whole=None):
        """``whole(state, fn)``: for a state of shards, calls ``fn(i,
        leaf)`` on each leaf gathered whole, in order (every rank takes
        part; only the writer keeps the host copies)."""
        self.wait()
        snap = self._snapshot(state, whole)  # device->host before returning
        if not self.writer:
            return
        self._thread = threading.Thread(
            target=self._write, args=(step, snap, extra or {}), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _snapshot(self, state, whole=None):
        paths = [tree.path_str(p) for p, _ in tree.flatten_with_path(state)]
        if whole is None:
            arrays = [_to_numpy(x) for x in tree.leaves(state)]
        else:
            arrays = []
            whole(state, lambda i, x: arrays.append(
                _to_numpy(x) if self.writer else None))
        return [(p, *a) for p, a in zip(paths, arrays)] if self.writer \
            else []

    def _write(self, step: int, leaves, extra: dict):
        final = os.path.join(self.root, f"step_{step:08d}")
        tmp = final + "_tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        index = {"step": step, "extra": extra, "leaves": []}
        for i, (path, arr, dtype) in enumerate(leaves):
            fn = f"{i:04d}.npy"
            _save_npy(os.path.join(tmp, fn), arr, dtype)
            index["leaves"].append({"path": path, "file": fn,
                                    "shape": list(arr.shape),
                                    "dtype": dtype})
        with open(os.path.join(tmp, "index.json"), "w") as f:
            json.dump(index, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for d in os.listdir(self.root):
            if d.startswith("step_") and not d.endswith("_tmp"):
                try:
                    out.append(int(d.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, device=None,
                shardings: Any = None):
        """Restore into the structure of ``like``, each leaf on ``device``
        (the CPU by default); with ``shardings`` (a tree of
        ``distributed.logical.NamedSharding``, None where a leaf stays
        whole), each leaf becomes a DTensor on its mesh.  Returns (tree,
        extra)."""
        d = os.path.join(self.root, f"step_{step:08d}")
        with open(os.path.join(d, "index.json")) as f:
            index = json.load(f)
        entries = index["leaves"]
        n_like = len(tree.leaves(like))
        if len(entries) != n_like:
            raise ValueError(
                f"checkpoint has {len(entries)} leaves, expected {n_like}")
        leaves = [_load_leaf(os.path.join(d, e["file"]), e["dtype"], device)
                  for e in entries]
        restored = tree.unflatten(like, leaves)
        if shardings is not None:
            from repro_torch.distributed.sharding import apply_shardings
            restored = apply_shardings(restored, shardings)
        return restored, index["extra"]
