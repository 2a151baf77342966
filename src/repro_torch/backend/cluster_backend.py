"""The cluster discrete-event backend: N matrix units, one shared loader.

``desim-cluster`` is ``desim`` scaled out: ``lower()`` tiles work as
usual, ``sim.partition`` shards the tiles across ``units`` (row-panel /
output-tile / layer-pipeline, with explicit inter-unit transfer nodes),
and ``sim.desim.simulate_cluster`` runs the partitioned graph on a
:class:`~repro_torch.sim.resources.ClusterTopology` — per-unit dispatcher,
scratchpad banks, PE array and vector unit, all contending for one
shared memory loader under a fair-share or FCFS bandwidth-partitioning
policy.  Given concrete operands, the *same* partitioned graph also
executes through ``execute_graph_torch`` / ``execute_workload_torch`` on
the default matmul route (on the card: K1, one launch per matrix tile),
so numbers come back alongside the contended timelines (the paper's
unified-stack claim, cluster-sized).  The cycles are simulated cycles of
the paper's CPU matrix units, not the time the execution took.
"""

from __future__ import annotations

from typing import Callable, Optional

from repro_torch.backend.base import (Backend, ExecResult, GraphOperands,
                                      MatMulOperands)
from repro_torch.backend.registry import register
from repro_torch.core.fusion import Epilogue, NO_EPILOGUE
from repro_torch.core.task import MatMulTask
from repro_torch.obs import instrument
from repro_torch.sim.resources import ClusterTopology


class PartitionedBackend(Backend):
    """Shared plumbing for the cluster-aware backends: a ``units``-wide
    partition strategy, TaskGraph sharding via ``sim.partition``, and
    the :class:`~repro_torch.sim.resources.ClusterTopology` the modelling
    halves price against.

    ``affinity``/``weights`` feed the ``unit-affinity`` strategy — a
    serving policy's per-step placement hints plus relative per-unit
    throughputs (heterogeneous clusters).  An explicit (possibly
    heterogeneous) ``topology`` wins over the scalar knobs: it fixes
    the cluster width and supplies the partitioner's throughput
    weights, so mixed-unit deployments price correctly.
    """

    supports_units = True

    def __init__(self, units: int = 2, strategy: str = "row-panel",
                 affinity: "dict[str, int] | None" = None,
                 weights: "list[float] | None" = None,
                 loader_policy: str = "fair",
                 total_bandwidth: Optional[float] = None,
                 k_stream: bool = True,
                 topology: Optional[ClusterTopology] = None, **kw):
        from repro_torch.sim.partition import STRATEGIES
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown partition strategy {strategy!r}; "
                             f"one of {STRATEGIES}")
        if topology is not None:
            units = topology.n_units
            kw.setdefault("unit", topology.unit)
            kw.setdefault("platform", topology.platform)
            kw.setdefault("vector", topology.vector)
            if topology.heterogeneous and weights is None:
                weights = topology.throughput_weights()
        super().__init__(units=units, **kw)
        self.strategy = strategy
        self.affinity = affinity
        self.weights = weights
        self._topology = topology
        self.loader_policy = loader_policy
        self.total_bandwidth = total_bandwidth
        self.k_stream = k_stream

    def topology(self, unit=None, platform=None,
                 vector=None) -> ClusterTopology:
        if self._topology is not None:
            return self._topology
        return ClusterTopology(
            n_units=self.units, unit=unit or self.unit,
            platform=platform or self.platform,
            vector=vector or self.vector,
            loader_policy=self.loader_policy,
            total_bandwidth=self.total_bandwidth,
            k_stream=self.k_stream)

    def partition(self, graph):
        """Shard an (unpartitioned) TaskGraph for this backend's cluster;
        pre-partitioned input (``sim.partition.Partition``) passes
        through."""
        from repro_torch.sim.partition import Partition, partition_graph
        if isinstance(graph, Partition):
            if graph.n_units != self.units:
                raise ValueError(
                    f"graph partitioned for {graph.n_units} unit(s) but "
                    f"backend has units={self.units}")
            return graph
        return partition_graph(graph, self.units, self.strategy,
                               affinity=self.affinity,
                               weights=self.weights)


@register("desim-cluster")
class ClusterDESimBackend(PartitionedBackend):
    """Multi-unit machine model + optional lockstep execution."""

    executes = True
    models_time = True
    matmul_string = "kernel"        # numeric half: the default route

    def _stage(self, task: MatMulTask, operands: MatMulOperands,
               epilogue: Epilogue) -> Callable[[], ExecResult]:
        ep = None if epilogue is NO_EPILOGUE else epilogue
        part = self.partition(self.lower(task, epilogue=ep))
        return lambda: self.run_graph(
            part, operands if operands.concrete else None)

    @instrument("run_graph")
    def run_graph(self, graph, operands: GraphOperands = None) -> ExecResult:
        from repro_torch.sim.desim import simulate_cluster
        from repro_torch.sim.lower import (execute_graph_torch,
                                           execute_workload_torch,
                                           step_spans)
        part = self.partition(graph)
        r = simulate_cluster(part.graph, self.topology())
        output, outputs = None, None
        if isinstance(operands, dict):
            outputs = execute_workload_torch(part.graph, operands)
        elif operands is not None and operands.concrete:
            output = execute_graph_torch(part.graph, operands.a,
                                         operands.b,
                                         operands=operands.epilogue)
        return ExecResult(
            output=output, outputs=outputs, cycles=r.cycles,
            seconds=r.seconds(),
            utilization=r.aggregate_matrix_utilization, timeline=r,
            detail={
                "utilizations": r.utilizations(),
                "unit_utilizations": r.unit_utilizations(),
                "loader_utilization": r.loader_utilization,
                "loader_contention": r.loader_contention(),
                "step_spans": step_spans(part.graph, r),
                "partition": {"strategy": part.strategy,
                              "n_units": part.n_units,
                              "transfers": part.n_transfers,
                              "transfer_bytes": part.transfer_bytes},
            })

    @instrument("run_workload")
    def run_workload(self, layers, *, fused=None, unit=None, platform=None,
                     vector=None):
        from repro_torch.sim.lower import cluster_workload
        return cluster_workload(
            self.topology(unit, platform, vector), layers,
            strategy=self.strategy,
            fused=self.fused if fused is None else fused,
            granularity=self.granularity,
            affinity=self.affinity, weights=self.weights)
