"""The unified execution contract: one ``asyncMatMul``, many engines.

The paper's central software claim is that a single asynchronous matmul
abstraction "conceals hardware details … and supports a unified software
stack" across four CPU platforms.  :class:`Backend` is that abstraction
for this repository: every engine — plain torch ops, the hand-written
CUDA fused-matmul kernel, the discrete-event machine model, the
closed-form analytical model — implements
the same four verbs with the paper's vocabulary:

* ``dispatch(task, operands) -> DispatchHandle`` — ``asyncMatMul``:
  fire one :class:`~repro_torch.core.task.MatMulTask` and return immediately.
  The task's ``Status`` interface register moves ``IDLE -> RUNNING``.
* ``check(handle)`` — ``checkMatmul`` as a non-blocking poll of the
  Status register.
* ``wait(handle) -> ExecResult`` — force completion; the Status register
  moves to ``DONE``.  Executing backends return tensors, modelling
  backends return cycles/timelines, the desim backend returns both.
* ``run_graph(graph, operands)`` — run a whole
  :class:`~repro_torch.sim.graph.TaskGraph` (the tiled, dependency-linked form
  one logical matmul or a serving schedule lowers to).

Granularity (``tile | panel | layer``) and epilogue fusion are
first-class: every backend is constructed with a
:class:`~repro_torch.sim.graph.Granularity` and a ``fused`` flag, and
``lower()`` applies them when tiling work into a TaskGraph — so the same
``MatMulTask`` travels the whole stack unchanged and only the engine
underneath differs.  A copy of the reference's ``repro/backend/base.py``.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Callable, Optional, Union

from repro_torch.core.config import CASE_STUDY, MatrixUnitConfig
from repro_torch.core.fusion import (Epilogue, EpilogueOperands, NO_EPILOGUE,
                                     NO_OPERANDS)
from repro_torch.core.hardware import CpuPlatform, SHUTTLE
from repro_torch.core.simulator import LayerTrace, SATURN_512, VectorUnit
from repro_torch.core.task import MatMulTask, Status


@dataclasses.dataclass(frozen=True)
class MatMulOperands:
    """Concrete tensors for one ``asyncMatMul``.

    ``a``/``b`` are the matrix operands (symbolic — i.e. absent — under
    the modelling backends, which read only the task descriptor);
    ``epilogue`` carries the vector-side tensors (bias, dequant scales,
    residual) the fused epilogue consumes.
    """

    a: object = None                       # (..., M, K) tensor
    b: object = None                       # (K, N) tensor
    epilogue: EpilogueOperands = NO_OPERANDS

    @property
    def concrete(self) -> bool:
        return self.a is not None and self.b is not None


NO_MATMUL_OPERANDS = MatMulOperands()

#: ``run_graph`` operands: one (a, b[, epilogue ops]) for a single-GEMM
#: graph, or {gemm label -> (a, b)} for a multi-GEMM schedule graph.
GraphOperands = Union[MatMulOperands, "dict[str, tuple]", None]


@dataclasses.dataclass
class ExecResult:
    """What ``wait``/``run_graph`` returns, across all backends.

    Executing backends fill ``output``/``outputs``; modelling backends
    fill ``cycles``/``seconds``/``utilization`` (+ ``timeline`` for the
    DES).  The desim backend fills both when given concrete operands.
    """

    output: object = None                  # single-GEMM numeric result
    outputs: "dict[str, object] | None" = None   # per-GEMM results (schedules)
    cycles: Optional[float] = None         # modelled makespan
    seconds: Optional[float] = None
    utilization: Optional[float] = None    # matrix-unit utilization
    timeline: object = None                # sim.desim.DESimResult
    detail: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class DispatchHandle:
    """The ``Status`` interface register, reified for any backend.

    ``done()`` reads the task's Status register — the same word
    ``checkMatmul`` polls in hardware — so a handle and its task can
    never disagree about completion.
    """

    task: MatMulTask
    _thunk: Callable[[], ExecResult]
    _result: Optional[ExecResult] = None

    def done(self) -> bool:
        return self.task.status is Status.DONE

    def force(self) -> ExecResult:
        if self._result is None:
            self._result = self._thunk()
            self.task.status = Status.DONE
        return self._result


class Backend(abc.ABC):
    """One execution engine behind the asyncMatMul contract."""

    name: str = "abstract"
    #: produces numeric outputs (tensors)
    executes: bool = False
    #: produces cycle estimates / timelines
    models_time: bool = False
    #: understands ``units > 1`` (cluster backends); single-unit engines
    #: reject it rather than silently mispricing a multi-unit deployment.
    supports_units: bool = False

    def __init__(self, unit: MatrixUnitConfig = CASE_STUDY,
                 platform: CpuPlatform = SHUTTLE,
                 vector: VectorUnit = SATURN_512,
                 granularity=None, fused: bool = True, units: int = 1):
        from repro_torch.sim.graph import Granularity
        if units != 1 and not self.supports_units:
            raise ValueError(
                f"backend {self.name!r} models a single matrix unit; for "
                f"units={units} use 'desim-cluster' (timelines), "
                "'analytical' (the contention-aware closed form) or "
                "'sharded' (execution)")
        self.unit = unit
        self.platform = platform
        self.vector = vector
        self.units = units
        self.granularity = Granularity(granularity or Granularity.TILE)
        self.fused = fused
        self.dispatched: "list[DispatchHandle]" = []

    # ----- asyncMatMul / checkMatmul ---------------------------------------
    def dispatch(self, task: MatMulTask,
                 operands: Optional[MatMulOperands] = None, *,
                 epilogue: Epilogue = NO_EPILOGUE) -> DispatchHandle:
        """Fire one task; returns immediately with a handle."""
        operands = operands or NO_MATMUL_OPERANDS
        thunk = self._stage(task, operands, epilogue)
        task.status = Status.RUNNING
        handle = DispatchHandle(task, thunk)
        self.dispatched.append(handle)
        return handle

    @abc.abstractmethod
    def _stage(self, task: MatMulTask, operands: MatMulOperands,
               epilogue: Epilogue) -> Callable[[], ExecResult]:
        """Validate eagerly, compute lazily: return the forcing thunk."""

    def check(self, handle: DispatchHandle) -> bool:
        """Non-blocking ``checkMatmul`` poll."""
        return handle.done()

    def wait(self, handle: DispatchHandle) -> ExecResult:
        return handle.force()

    def drain(self) -> "list[ExecResult]":
        """Force every outstanding handle, oldest first, and forget them."""
        out = [h.force() for h in self.dispatched]
        self.dispatched.clear()
        return out

    # ----- granularity-aware lowering --------------------------------------
    def lower(self, work, *,
              epilogue: Optional[Epilogue] = None,
              vector_ops: "dict[str, float] | None" = None):
        """Tile ``work`` into a TaskGraph at this backend's granularity.

        :param work: one of

            * a single :class:`~repro_torch.core.task.MatMulTask` — tiled by
              ``build_gemm_graph``; an optional fused ``epilogue`` has
              its abstract Saturn cost attached so the same graph
              carries both the simulation and the execution payload;
            * a list of :class:`~repro_torch.core.simulator.LayerTrace`\\ s —
              a workload, chained serially with this backend's
              ``fused`` policy via ``workload_to_graph``;
            * a serving ``BatchSchedule`` (any object with ``steps``
              and ``layers``) — lowered via
              ``schedule_to_graph`` with the schedule's own ``overlap``
              mode (``"relaxed"`` keeps only true per-request hazard
              edges) and its arrival-derived release times stamped on
              the nodes.
        :param epilogue: fused epilogue for the single-task form only.
        :param vector_ops: explicit abstract vector costs (single-task
            form only; derived from ``epilogue`` when omitted).
        :returns: a :class:`~repro_torch.sim.graph.TaskGraph` ready for
            ``run_graph``.
        """
        from repro_torch.sim.lower import (epilogue_vector_ops,
                                           schedule_to_graph,
                                           workload_to_graph)
        from repro_torch.sim.graph import build_gemm_graph
        if isinstance(work, MatMulTask):
            if epilogue is not None and vector_ops is None:
                vector_ops = epilogue_vector_ops(epilogue, work.m, work.n)
            graph, _ = build_gemm_graph(
                work, self.unit.m_scp, self.unit.n_scp,
                granularity=self.granularity, vector_ops=vector_ops,
                epilogue=epilogue)
            return graph
        if epilogue is not None or vector_ops is not None:
            raise ValueError(
                "epilogue/vector_ops apply to a single MatMulTask; a "
                "LayerTrace workload carries its own vector work")
        if hasattr(work, "steps") and hasattr(work, "layers"):
            return schedule_to_graph(self.unit, work, fused=self.fused,
                                     granularity=self.granularity,
                                     platform=self.platform)
        return workload_to_graph(self.unit, list(work), fused=self.fused,
                                 granularity=self.granularity,
                                 platform=self.platform)

    # ----- whole-graph / whole-workload entry points -----------------------
    @abc.abstractmethod
    def run_graph(self, graph, operands: GraphOperands = None) -> ExecResult:
        """Run a TaskGraph end to end."""

    def run_workload(self, layers: "list[LayerTrace]", *,
                     fused: Optional[bool] = None,
                     unit: Optional[MatrixUnitConfig] = None,
                     platform: Optional[CpuPlatform] = None,
                     vector: Optional[VectorUnit] = None) -> "dict[str, float]":
        """Model-level cost of a LayerTrace workload (modelling backends
        only); same dict shape as ``core.simulator.simulate_workload``."""
        raise NotImplementedError(
            f"backend {self.name!r} executes numbers but has no workload "
            "cost model; use backend.get('desim') or "
            "backend.get('analytical')")

    def __repr__(self) -> str:
        return (f"<{type(self).__name__} {self.name!r} "
                f"granularity={self.granularity.value} fused={self.fused}>")
