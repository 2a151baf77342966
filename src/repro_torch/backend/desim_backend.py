"""The discrete-event backend: timelines *and* results from one graph.

``dispatch``/``run_graph`` run the TaskGraph on the resource-level
machine model (``sim.desim``) for the per-resource timeline, and — when
concrete operands are supplied — execute the *same* graph through
``execute_graph_torch``/``execute_workload_torch`` on the default matmul
route (the CUDA kernel unless ``set_default_matmul_backend`` says
otherwise), so the numbers come back alongside the cycles.  The cycles
are simulated cycles of the paper's CPU matrix unit, not the time the
execution took.
"""

from __future__ import annotations

from typing import Callable

from repro_torch.backend.base import (Backend, ExecResult, GraphOperands,
                                      MatMulOperands)
from repro_torch.backend.registry import register
from repro_torch.core.fusion import Epilogue, NO_EPILOGUE
from repro_torch.core.task import MatMulTask
from repro_torch.obs import instrument


@register("desim")
class DESimBackend(Backend):
    """Discrete-event machine model + optional lockstep execution."""

    executes = True
    models_time = True
    matmul_string = "kernel"        # numeric half: the default route

    def _stage(self, task: MatMulTask, operands: MatMulOperands,
               epilogue: Epilogue) -> Callable[[], ExecResult]:
        ep = None if epilogue is NO_EPILOGUE else epilogue
        graph = self.lower(task, epilogue=ep)
        return lambda: self.run_graph(
            graph, operands if operands.concrete else None)

    @instrument("run_graph")
    def run_graph(self, graph, operands: GraphOperands = None) -> ExecResult:
        from repro_torch.sim.desim import simulate_graph
        from repro_torch.sim.lower import (execute_graph_torch,
                                           execute_workload_torch,
                                           step_spans)
        r = simulate_graph(graph, self.unit, self.platform, self.vector)
        output, outputs = None, None
        if isinstance(operands, dict):
            outputs = execute_workload_torch(graph, operands)
        elif operands is not None and operands.concrete:
            output = execute_graph_torch(graph, operands.a, operands.b,
                                         operands=operands.epilogue)
        return ExecResult(output=output, outputs=outputs, cycles=r.cycles,
                          seconds=r.seconds(),
                          utilization=r.matrix_utilization, timeline=r,
                          detail={"utilizations": r.utilizations(),
                                  "step_spans": step_spans(graph, r)})

    @instrument("run_workload")
    def run_workload(self, layers, *, fused=None, unit=None, platform=None,
                     vector=None):
        from repro_torch.sim.lower import desim_workload
        return desim_workload(
            unit or self.unit, layers,
            platform=platform or self.platform,
            vector=vector or self.vector,
            fused=self.fused if fused is None else fused,
            granularity=self.granularity)
