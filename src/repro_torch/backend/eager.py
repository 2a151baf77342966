"""Executing backends: plain torch ops and the CUDA fused-matmul kernel.

Both wrap :class:`~repro_torch.core.engine.AsyncMatmulEngine` — dispatch
launches (CUDA) or stages (CPU) the tile, wait forces it — and differ
only in which ``cute_matmul`` route they take: ``"torch"`` (the
reference's ``jax`` backend) or ``"kernel"`` (its ``pallas`` backend:
one launch of the hand-written fused matmul per call, which raises
rather than fall back when the launch fails; on CPU tensors the
kernel's plain version).  ``run_graph`` walks a TaskGraph through
``execute_graph_torch`` (single GEMM, fused epilogues applied at the
graph's granularity) or ``execute_workload_torch`` (multi-GEMM schedule
graphs, one ``(a, b)`` pair per GEMM label).
"""

from __future__ import annotations

from typing import Callable

from repro_torch.backend.base import (Backend, ExecResult, GraphOperands,
                                      MatMulOperands, NO_MATMUL_OPERANDS)
from repro_torch.backend.registry import register
from repro_torch.core.engine import AsyncMatmulEngine
from repro_torch.core.fusion import Epilogue
from repro_torch.core.task import MatMulTask
from repro_torch.obs import instrument


class _EagerBackend(Backend):
    """Shared dispatch/run_graph plumbing for the executing backends."""

    executes = True
    matmul_string = "kernel"       # the cute_matmul(backend=...) route

    def __init__(self, **kw):
        super().__init__(**kw)
        self._engine = AsyncMatmulEngine(unit=self.unit,
                                         backend=self.matmul_string)

    def _stage(self, task: MatMulTask, operands: MatMulOperands,
               epilogue: Epilogue) -> Callable[[], ExecResult]:
        if not operands.concrete:
            raise ValueError(
                f"backend {self.name!r} executes numbers: dispatch needs "
                "MatMulOperands(a=..., b=...)")
        h = self._engine.dispatch(task, operands.a, operands.b,
                                  epilogue=epilogue,
                                  operands=operands.epilogue)
        return lambda: ExecResult(output=h.force())

    @instrument("run_graph")
    def run_graph(self, graph, operands: GraphOperands = None) -> ExecResult:
        from repro_torch.sim.lower import (execute_graph_torch,
                                           execute_workload_torch)
        engine = self._engine
        if isinstance(operands, dict):
            outs = execute_workload_torch(graph, operands, engine=engine)
            return ExecResult(outputs=outs)
        ops = operands or NO_MATMUL_OPERANDS
        if not ops.concrete:
            raise ValueError(
                f"backend {self.name!r} needs concrete operands: pass "
                "MatMulOperands(a, b) or a {gemm label: (a, b)} dict")
        out = execute_graph_torch(graph, ops.a, ops.b,
                                  operands=ops.epilogue, engine=engine)
        return ExecResult(output=out)


@register("torch")
class TorchBackend(_EagerBackend):
    """Eager execution through ``torch.matmul`` + the epilogue as tensor
    ops."""

    matmul_string = "torch"


@register("kernel")
class KernelBackend(_EagerBackend):
    """Execution through the hand-written CUDA fused matmul (K1)."""

    matmul_string = "kernel"
