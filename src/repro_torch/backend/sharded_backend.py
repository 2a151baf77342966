"""The sharded execution backend: the partitioned graph, run for real.

``sharded`` executes the *identical* partitioned TaskGraph the
``desim-cluster`` backend times: ``sim.partition`` decides which unit
owns which tiles, and execution maps units onto ranks —
``distributed.sharding.shard_map_gemm`` computes each unit's output
block through K1, one call a span, on rank u of a world of ``units``
ranks (an ``all_gather`` assembles the block on every rank), or through
an arithmetically identical per-span loop in one process otherwise, so
int8 results are bit-exact against the ``torch`` and ``kernel`` backends
either way.  Epilogue-carrying vector nodes are applied to the assembled
accumulator through the same region walk the single-device lowering uses
(``sim.lower.apply_graph_epilogues``).
"""

from __future__ import annotations

from typing import Callable

from repro_torch.backend.base import (ExecResult, GraphOperands,
                                      MatMulOperands, NO_MATMUL_OPERANDS)
from repro_torch.backend.cluster_backend import PartitionedBackend
from repro_torch.backend.registry import register
from repro_torch.core.fusion import Epilogue, NO_EPILOGUE
from repro_torch.core.task import MatMulTask
from repro_torch.obs import instrument


@register("sharded")
class ShardedBackend(PartitionedBackend):
    """Cluster-partitioned execution over ranks (``launch.mesh``), K1 a
    span."""

    executes = True
    matmul_string = "kernel"

    @property
    def shard_dim(self):
        from repro_torch.sim.partition import STRATEGY_DIM
        return STRATEGY_DIM[self.strategy]

    def _stage(self, task: MatMulTask, operands: MatMulOperands,
               epilogue: Epilogue) -> Callable[[], ExecResult]:
        if not operands.concrete:
            raise ValueError(
                f"backend {self.name!r} executes numbers: dispatch needs "
                "MatMulOperands(a=..., b=...)")
        ep = None if epilogue is NO_EPILOGUE else epilogue
        part = self.partition(self.lower(task, epilogue=ep))
        return lambda: self.run_graph(part, operands)

    @instrument("run_graph")
    def run_graph(self, graph, operands: GraphOperands = None) -> ExecResult:
        from repro_torch.sim.lower import (_subgraph_for_gemm, gemm_labels,
                                           iter_gemm_operands)
        part = self.partition(graph)
        g = part.graph
        detail = {"partition": {"strategy": part.strategy,
                                "n_units": part.n_units,
                                "transfers": part.n_transfers}}
        if isinstance(operands, dict):
            outs = {}
            for label, a, b, eops in iter_gemm_operands(g, operands):
                outs[label] = self._execute_gemm(
                    _subgraph_for_gemm(g, label), a, b, eops,
                    part.spans.get(label))
            return ExecResult(outputs=outs, detail=detail)
        ops = operands or NO_MATMUL_OPERANDS
        if not ops.concrete:
            raise ValueError(
                f"backend {self.name!r} needs concrete operands: pass "
                "MatMulOperands(a, b) or a {gemm label: (a, b)} dict")
        labels = gemm_labels(g)
        if len(labels) > 1:
            raise ValueError(
                f"graph spans {len(labels)} GEMMs; pass a "
                "{gemm label: (a, b)} operand dict")
        out = self._execute_gemm(g, ops.a, ops.b, ops.epilogue,
                                 part.spans.get(labels[0]))
        return ExecResult(output=out, detail=detail)

    def _execute_gemm(self, graph, a, b, eops, spans=None):
        """One GEMM's partitioned subgraph on real tensors; ``spans`` is
        the partition's per-unit extent list, so execution reproduces
        the exact unit-to-data mapping the DES timed."""
        from repro_torch.core.fusion import _infer_policy
        from repro_torch.distributed.sharding import shard_map_gemm
        from repro_torch.sim.lower import apply_graph_epilogues
        policy = _infer_policy(a)
        dim = self.shard_dim
        # layer-pipeline keeps each whole GEMM on one unit: within a
        # single GEMM there is nothing to shard.
        n = self.units if dim is not None else 1
        acc = shard_map_gemm(a, b, n, dim=dim or "m",
                             accum_dtype=policy.accum_dtype,
                             bounds=spans if dim is not None else None)
        return apply_graph_epilogues(graph, acc, operands=eops,
                                     in_dtype=a.dtype)
