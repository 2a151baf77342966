"""Discrete-event task-graph runtime for the CUTEv2 reproduction.

One ``TaskGraph`` IR (``sim.graph``) drives two consumers:

* ``sim.desim`` — a discrete-event, resource-level simulator (CPU
  dispatcher, memory loader, scratchpad banks, PE array, Saturn vector
  unit) that derives per-resource timelines instead of asserting the
  closed-form ``max(matrix, vec)`` of ``core.simulator``.
* ``sim.lower`` — a lowering that executes the *same* graph through
  ``AsyncMatmulEngine``/``cute_matmul`` on real tensors (on a CUDA card,
  one launch of the fused-matmul kernel per matrix tile), making the
  paper's "unified software stack" literal.

``sim.trace`` exports the simulated timelines as Chrome-trace JSON
(viewable in Perfetto / chrome://tracing).

The port of the reference's ``repro.sim``: the pure-Python layers are
copies, held to identical results by ``tests/test_torch_sim.py``; the
DES cycles are simulated cycles of the paper's CPU matrix unit.
"""

from repro_torch.sim.graph import (Granularity, Node, TaskGraph,
                                   build_gemm_graph)
from repro_torch.sim.resources import (BandwidthResource, ClusterTopology,
                                       UnitSpec)
from repro_torch.sim.desim import (ClusterDESimResult, DESimResult, Machine,
                                   build_cluster, simulate_cluster,
                                   simulate_graph)
from repro_torch.sim.partition import (Partition, STRATEGIES, partition_graph)
from repro_torch.sim.lower import (OVERLAP_MODES, cluster_workload, desim_gemm,
                                   desim_layer, desim_workload,
                                   epilogue_vector_ops, execute_graph_torch,
                                   execute_workload_torch, exposed_dispatch,
                                   gemm_labels, layer_to_graph,
                                   schedule_to_graph, step_spans,
                                   workload_to_graph)
from repro_torch.sim.trace import chrome_trace, dump_chrome_trace

__all__ = [
    "Granularity", "Node", "TaskGraph", "build_gemm_graph",
    "BandwidthResource", "ClusterTopology", "UnitSpec",
    "ClusterDESimResult", "DESimResult", "Machine", "build_cluster",
    "simulate_cluster", "simulate_graph",
    "Partition", "STRATEGIES", "partition_graph",
    "OVERLAP_MODES", "cluster_workload", "desim_gemm", "desim_layer",
    "desim_workload", "epilogue_vector_ops", "execute_graph_torch",
    "execute_workload_torch", "exposed_dispatch", "gemm_labels",
    "layer_to_graph", "schedule_to_graph", "step_spans",
    "workload_to_graph",
    "chrome_trace", "dump_chrome_trace",
]
