"""The asynchronous programming model: ``asyncMatMul`` / ``checkMatmul``.

Paper Listing 1::

    for (tile in tiles) asyncMatMul(tile);          // fire and forget
    for (tile in tiles) { checkMatmul(tile);        // sync primitive
                          vector_epilogue(tile); }  // overlapped on VPU

On a GPU the asynchrony is real.  ``AsyncMatmulEngine`` keeps the paper's
dispatch/check/wait vocabulary:

* ``dispatch(task, a, b, ...)`` returns a ``Handle`` at once.  For CUDA
  operands it launches ``cute_matmul`` on a side stream and records an
  event behind it; for CPU operands the call is staged and runs when
  forced, as in the reference.
* ``check(handle)`` polls: ``event.query()`` on CUDA.
* ``wait(handle)`` synchronises on the event (or runs the staged call)
  and sets the task's Status to DONE.
* ``pipelined_fused_matmul`` is Listing 1 end-to-end: tile the M axis,
  dispatch every tile, then walk the tiles applying the vector epilogue.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.config import CASE_STUDY, MatrixUnitConfig
from repro_torch.core.fusion import (NO_EPILOGUE, NO_OPERANDS, Epilogue,
                                     EpilogueOperands, cute_matmul)
from repro_torch.core.task import MatMulTask, Status, tile_tasks


@dataclasses.dataclass
class Handle:
    """The ``Status`` interface register, reified.

    ``done()`` reads the task's Status register, so a handle and its task
    never disagree about completion (``IDLE -> RUNNING`` at dispatch,
    ``-> DONE`` when waited on).  ``event`` is set for work launched on a
    CUDA side stream; ``_thunk`` for work staged on the CPU.
    """

    task: MatMulTask
    _thunk: Optional[Callable[[], torch.Tensor]] = None
    _result: Optional[torch.Tensor] = None
    event: Optional["torch.cuda.Event"] = None

    def done(self) -> bool:
        return self.task.status is Status.DONE

    def ready(self) -> bool:
        """checkMatmul: has the device finished (never blocks)?"""
        if self.event is not None:
            return self.event.query()
        return self.done()

    def force(self) -> torch.Tensor:
        if self.event is not None:
            if not self.done():
                self.event.synchronize()
                stream = torch.cuda.current_stream(self._result.device)
                stream.wait_event(self.event)
                self._result.record_stream(stream)
        elif self._result is None:
            self._result = self._thunk()
        self.task.status = Status.DONE
        return self._result


class AsyncMatmulEngine:
    """Software façade of the decoupled matrix unit."""

    def __init__(self, unit: MatrixUnitConfig = CASE_STUDY,
                 backend: Optional[str] = None):
        self.unit = unit
        self.backend = backend          # cute_matmul route; None: default
        self.dispatched: "list[Handle]" = []
        self._stream = None

    # -- asyncMatMul --------------------------------------------------------
    def dispatch(self, task: MatMulTask, a: torch.Tensor, b: torch.Tensor, *,
                 epilogue: Epilogue = NO_EPILOGUE,
                 operands: EpilogueOperands = NO_OPERANDS) -> Handle:
        if (tuple(a.shape[-2:]) != (task.m, task.k)
                or tuple(b.shape[-2:]) != (task.k, task.n)):
            raise ValueError(
                f"operands {tuple(a.shape)}x{tuple(b.shape)} disagree with "
                f"task {task.m}x{task.k}x{task.n}")
        task.status = Status.RUNNING

        def run():
            return cute_matmul(a, b, epilogue=epilogue, operands=operands,
                               backend=self.backend)
        if a.is_cuda:
            h = self._launch(task, (a, b), run)
        else:
            h = Handle(task, _thunk=run)
        self.dispatched.append(h)
        return h

    def _launch(self, task: MatMulTask, inputs, run) -> Handle:
        """Run ``run`` on the engine's side stream, behind the work already
        queued on the current stream, and record an event after it."""
        a = inputs[0]
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=a.device)
        main = torch.cuda.current_stream(a.device)
        self._stream.wait_stream(main)
        for t in inputs:       # keep their memory until the side stream is done
            t.record_stream(self._stream)
        with torch.cuda.stream(self._stream):
            out = run()
            event = torch.cuda.Event()
            event.record(self._stream)
        return Handle(task, _result=out, event=event)

    # -- checkMatmul --------------------------------------------------------
    def check(self, handle: Handle) -> bool:
        return handle.ready()

    def wait(self, handle: Handle) -> torch.Tensor:
        return handle.force()

    def drain(self) -> "list[torch.Tensor]":
        return [h.force() for h in self.dispatched]


def pipelined_fused_matmul(a: torch.Tensor, b: torch.Tensor,
                           vector_epilogue: Callable[[torch.Tensor],
                                                     torch.Tensor],
                           *, tile_m: int = 128,
                           engine: Optional[AsyncMatmulEngine] = None,
                           task: Optional[MatMulTask] = None) -> torch.Tensor:
    """Listing 1, faithfully: tile-granular dispatch + overlapped epilogue.

    ``vector_epilogue`` is arbitrary vector-unit work (softmax, RMSNorm,
    dequant...) applied per M-tile.  On CUDA every tile's matmul is queued
    on the side stream before the first epilogue runs.
    """
    if engine is None:
        engine = AsyncMatmulEngine()
    m, k = a.shape[-2:]
    n = b.shape[-1]
    if task is None:
        task = MatMulTask(m=m, n=n, k=k)
    if m % tile_m:
        raise ValueError(f"tile_m={tile_m} must divide M={m}")

    handles = []
    for i, sub in enumerate(tile_tasks(task, tile_m, n)):
        a_tile = a.narrow(-2, i * tile_m, tile_m)
        handles.append(engine.dispatch(sub, a_tile, b))       # asyncMatMul
    outs = []
    for h in handles:                                         # checkMatmul
        outs.append(vector_epilogue(engine.wait(h)))          # vector work
    return torch.cat(outs, dim=-2)
