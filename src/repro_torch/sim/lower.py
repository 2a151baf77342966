"""Lowerings in and out of the TaskGraph IR.

In:  ``layer_to_graph`` / ``workload_to_graph`` convert the analytical
model's :class:`~repro_torch.core.simulator.LayerTrace` records (and anything
built on ``MatMulTask``) into dependency-linked TaskGraphs, fused
(Listing 1: per-tile epilogues overlap the matrix stream) or unfused
(vector phase after all tiles, with the DRAM round-trip of the
intermediate as an explicit memory node).

Out (machine): ``desim_layer`` / ``desim_workload`` run the graphs on
the discrete-event machine and report the same dict shape as
``simulate_layer`` / ``simulate_workload`` so callers can swap engines.

Out (tensors): ``execute_graph_torch`` walks the *same* graph and
executes it through ``AsyncMatmulEngine``/``cute_matmul`` — matrix nodes
dispatch accumulator-tile matmuls (on the ``"kernel"`` route, one launch
of the CUDA fused matmul per tile), vector nodes apply the fused
epilogue — which is the paper's unified-software-stack claim made
literal: one IR, one schedule, two targets.  ``execute_workload_torch``
extends that to multi-GEMM schedule graphs (e.g. a serving step's
``LayerTrace`` lowered by ``workload_to_graph``): one ``{gemm label:
(a, b)}`` operand dict, one output dict, same program order the DES
timed.  The pair is the port's counterpart of the reference's
``execute_graph_jax`` / ``execute_workload_jax``; everything else here
is a copy of ``repro/sim/lower.py``.

The cycles the DES reports are simulated cycles of the paper's CPU
matrix unit (``MatrixUnitConfig.freq_hz``), not time on the GPU that
executes the graph.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import torch

from repro_torch.core.config import MatrixUnitConfig
from repro_torch.core.engine import AsyncMatmulEngine
from repro_torch.core.fusion import (Epilogue, EpilogueOperands, NO_OPERANDS,
                                     _infer_policy, apply_epilogue)
from repro_torch.core.hardware import CpuPlatform, SHUTTLE
from repro_torch.core.simulator import (LayerTrace, SATURN_512,
                                        VECTOR_OP_INSTRS, VectorUnit)
from repro_torch.core.task import BiasType, MatMulTask
from repro_torch.sim.desim import DESimResult, simulate_graph
from repro_torch.sim.graph import (Granularity, Node, TaskGraph,
                                   build_gemm_graph, group_tiles)


# ---------------------------------------------------------------------------
# LayerTrace -> TaskGraph.
# ---------------------------------------------------------------------------

def layer_to_graph(unit: MatrixUnitConfig, layer: LayerTrace, *,
                   fused: bool = True,
                   granularity: Granularity = Granularity.TILE,
                   platform: CpuPlatform = SHUTTLE,
                   graph: Optional[TaskGraph] = None,
                   deps=()) -> "tuple[TaskGraph, list[Node]]":
    """One LayerTrace execution (repeat is handled by the caller).

    Fused: the layer's vector work is spread over epilogue nodes at the
    requested granularity, so it streams behind the matrix tiles.
    Unfused: every tile completes, the intermediate (beyond the L2
    working set) round-trips DRAM as a memory node, then one vector node
    runs the whole epilogue phase.
    """
    graph = graph if graph is not None else TaskGraph()
    tiles: "list[Node]" = []
    gemm_groups: "list[list[Node]]" = []     # granularity applied per GEMM
    for gi, g in enumerate(layer.gemms):
        graph, t = build_gemm_graph(
            g, unit.m_scp, unit.n_scp, graph=graph, deps=deps,
            layer=f"{layer.name}/g{gi}")
        tiles.extend(t)
        gemm_groups.extend(group_tiles(t, granularity, g.n, unit.n_scp))
    if not layer.vector_ops:
        return graph, tiles

    if fused:
        groups = [tiles] if granularity == Granularity.LAYER else gemm_groups
        share = {op: n / len(groups) for op, n in layer.vector_ops.items()}
        vecs = [graph.add("vector", f"{layer.name}/vec{i}",
                          deps=tuple(t.nid for t in grp), layer=layer.name,
                          vector_ops=dict(share))
                for i, grp in enumerate(groups)]
        return graph, vecs

    spill = max(0.0, layer.intermediate_bytes - platform.l2_bytes)
    vdeps = [t.nid for t in tiles]
    if spill > 0:
        # store + reload of the intermediate through the memory loader.
        mem = graph.add("memory", f"{layer.name}/spill",
                        deps=tuple(vdeps), layer=layer.name,
                        mem_bytes=2.0 * spill)
        vdeps = [mem.nid]
    vec = graph.add("vector", f"{layer.name}/vec", deps=tuple(vdeps),
                    layer=layer.name, vector_ops=dict(layer.vector_ops))
    return graph, [vec]


#: ``workload_to_graph`` step-chaining modes (see ``overlap=``).
OVERLAP_MODES = ("chained", "relaxed")


def workload_to_graph(unit: MatrixUnitConfig, layers: "list[LayerTrace]", *,
                      fused: bool = True,
                      granularity: Granularity = Granularity.TILE,
                      platform: CpuPlatform = SHUTTLE,
                      expand_repeat: bool = False,
                      overlap: str = "chained",
                      step_deps: "list[tuple[int, ...]] | None" = None,
                      release_times: "list[float] | None" = None,
                      refill_bytes: "list[float] | None" = None,
                      ) -> TaskGraph:
    """Lower a list of ``LayerTrace`` steps into one TaskGraph.

    :param unit: matrix-unit geometry the GEMMs are tiled for.
    :param layers: one :class:`~repro_torch.core.simulator.LayerTrace` per
        schedule step (e.g. a serving ``BatchSchedule.layers``).
    :param fused: attach per-granularity epilogue vector nodes (Listing
        1 overlap) instead of one post-GEMM vector phase with the
        intermediate's DRAM round-trip.
    :param granularity: how much vector work rides behind each
        synchronisation point (``TILE`` / ``PANEL`` / ``LAYER``).
    :param platform: CPU platform (dispatch/check costs, DRAM derate).
    :param expand_repeat: instantiate ``layer.repeat`` copies of each
        step; by default one instance per step is emitted (the DES
        multiplies, like the analytical model).
    :param overlap: how successive steps are linked.

        * ``"chained"`` (default) — layer *i+1*'s tiles depend on layer
          *i*'s sinks: the whole schedule is one serial chain, the safe
          over-approximation every pre-overlap caller used.
        * ``"relaxed"`` — step *i*'s deps are only the sinks of the
          steps named by ``step_deps[i]`` (its true data hazards, e.g.
          the per-request KV/activation chain a
          :meth:`~repro_torch.serving.engine.BatchSchedule.step_deps`
          computes).  Steps with no hazard between them carry **no
          edge**: placed on disjoint units they genuinely run
          concurrently, and per-unit resource ordering is left to the
          DES (same-unit steps still serialise on the dispatcher, banks
          and PE).  Results are unchanged — execution order per GEMM is
          dependency-driven either way.
    :param step_deps: per-step dependency lists (indices into
        ``layers``), required when ``overlap="relaxed"``; each entry may
        only name earlier steps.
    :param release_times: per-step earliest-start cycles (request
        arrival semantics): stamped on every node of the step as
        :attr:`~repro_torch.sim.graph.Node.release_time`, honoured by the DES
        and approximated by the analytical backend.  ``None`` means
        everything is available at t = 0.
    :param refill_bytes: per-step KV-cache refill bytes (paged-KV
        residency — see :mod:`repro_torch.serving.kvcache`): a step owing a
        nonzero refill gets a ``memory`` node ``<name>/kv_refill``
        *ahead of its tiles*, riding the shared/private
        ``BandwidthResource`` loaders exactly like a spill round-trip,
        so the DES and the analytical form both price the refill while
        execution (memory nodes are simulation-only) is unchanged.
        ``None`` means KV is free and always resident.
    """
    if overlap not in OVERLAP_MODES:
        raise ValueError(f"unknown overlap mode {overlap!r}; one of "
                         f"{OVERLAP_MODES}")
    if overlap == "relaxed":
        if step_deps is None:
            raise ValueError('overlap="relaxed" needs step_deps (the '
                             "true cross-step data hazards); use "
                             "BatchSchedule.step_deps() for schedules")
        if len(step_deps) != len(layers):
            raise ValueError(f"{len(step_deps)} step_deps entries for "
                             f"{len(layers)} steps")
    if release_times is not None and len(release_times) != len(layers):
        raise ValueError(f"{len(release_times)} release_times for "
                         f"{len(layers)} steps")
    if refill_bytes is not None and len(refill_bytes) != len(layers):
        raise ValueError(f"{len(refill_bytes)} refill_bytes for "
                         f"{len(layers)} steps")
    graph = TaskGraph()
    step_sinks: "list[list[int]]" = []
    deps: "list[int]" = []
    for i, layer in enumerate(layers):
        if overlap == "relaxed":
            deps = []
            for d in step_deps[i]:
                if not 0 <= d < i:
                    raise ValueError(
                        f"step {i} depends on step {d}; deps must name "
                        "earlier steps")
                deps.extend(step_sinks[d])
        first_nid = len(graph)
        if refill_bytes is not None and refill_bytes[i] > 0.0:
            # evicted-block refill: the step's KV streams back through
            # the memory loader before its first tile may start.
            mem = graph.add("memory", f"{layer.name}/kv_refill",
                            deps=tuple(deps), layer=layer.name,
                            mem_bytes=float(refill_bytes[i]))
            deps = [mem.nid]
        for _ in range(layer.repeat if expand_repeat else 1):
            graph, sinks = layer_to_graph(
                unit, layer, fused=fused, granularity=granularity,
                platform=platform, graph=graph, deps=tuple(deps))
            deps = [s.nid for s in sinks]
        step_sinks.append(list(deps))
        if release_times is not None and release_times[i] > 0.0:
            for node in graph.nodes[first_nid:]:
                node.release_time = release_times[i]
    return graph


def schedule_to_graph(unit: MatrixUnitConfig, sched, *,
                      fused: bool = True,
                      granularity: Granularity = Granularity.TILE,
                      platform: CpuPlatform = SHUTTLE,
                      overlap: "Optional[str]" = None) -> TaskGraph:
    """Lower a serving ``BatchSchedule`` with its own overlap mode,
    hazard deps and arrival-derived release times — the schedule-aware
    form of :func:`workload_to_graph` every backend's ``lower()`` uses
    when handed a schedule instead of bare layers.  ``overlap``
    overrides the schedule's recorded mode without mutating it (the
    tuned-dispatch path re-lowers one plan under a cached overlap
    choice)."""
    overlap = overlap or getattr(sched, "overlap", "chained")
    return workload_to_graph(
        unit, list(sched.layers), fused=fused, granularity=granularity,
        platform=platform, overlap=overlap,
        step_deps=(sched.step_deps() if overlap == "relaxed" else None),
        release_times=list(getattr(sched, "release_times", ()) or ())
        or None,
        refill_bytes=list(getattr(sched, "refill_bytes", ()) or ())
        or None)


# ---------------------------------------------------------------------------
# DES-backed equivalents of simulate_layer / simulate_workload.
# ---------------------------------------------------------------------------

def desim_layer(unit: MatrixUnitConfig, layer: LayerTrace, *,
                platform: CpuPlatform = SHUTTLE,
                vector: VectorUnit = SATURN_512,
                fused: bool = True,
                granularity: Granularity = Granularity.TILE,
                ) -> "dict[str, float]":
    graph, _ = layer_to_graph(unit, layer, fused=fused,
                              granularity=granularity, platform=platform)
    r = simulate_graph(graph, unit, platform, vector)
    return {"cycles": r.cycles * layer.repeat,
            "matrix": r.busy("pe_array") * layer.repeat,
            "vector": r.busy("vector_unit") * layer.repeat,
            "result": r}


def desim_workload(unit: MatrixUnitConfig, layers: "list[LayerTrace]", *,
                   platform: CpuPlatform = SHUTTLE,
                   vector: VectorUnit = SATURN_512,
                   fused: bool = True,
                   granularity: Granularity = Granularity.TILE,
                   ) -> "dict[str, float]":
    tot = {"cycles": 0.0, "matrix": 0.0, "vector": 0.0}
    ideal = 0.0
    for layer in layers:
        r = desim_layer(unit, layer, platform=platform, vector=vector,
                        fused=fused, granularity=granularity)
        for k in tot:
            tot[k] += r[k]
        ideal += r["result"].ideal_matrix_cycles * layer.repeat
    tot["seconds"] = tot["cycles"] / unit.freq_hz
    tot["flops"] = sum(l.flops() for l in layers)
    tot["matrix_utilization"] = ideal / tot["cycles"] if tot["cycles"] else 0.0
    return tot


def desim_gemm(unit: MatrixUnitConfig, task: MatMulTask,
               platform: CpuPlatform = SHUTTLE,
               vector: VectorUnit = SATURN_512) -> DESimResult:
    """Bare GEMM through the DES (the Fig. 6 experiment shape)."""
    graph, _ = build_gemm_graph(task, unit.m_scp, unit.n_scp)
    return simulate_graph(graph, unit, platform, vector)


def exposed_dispatch(unit: MatrixUnitConfig, task: MatMulTask,
                     platform: CpuPlatform,
                     vector: VectorUnit = SATURN_512) -> float:
    """Cycles the CPU interface adds to the makespan: simulated time
    minus the same graph on an idealised zero-cost interface.  The
    CSR-mailbox platform (Kunminghu) exposes far more than RoCC ones in
    tile streams whose per-tile service time is comparable to the
    dispatch cost (paper Table 3 / §4.4)."""
    real = desim_gemm(unit, task, platform, vector).cycles
    free = dataclasses.replace(platform, dispatch_cycles=0, check_cycles=0)
    return real - desim_gemm(unit, task, free, vector).cycles


# ---------------------------------------------------------------------------
# TaskGraph -> tensor execution (the same graph, run for real).
# ---------------------------------------------------------------------------

def _slice_operands(ops: EpilogueOperands, ep: Epilogue,
                    m0: int, m: int, n0: int, n: int) -> EpilogueOperands:
    def cut(x, sl):
        return None if x is None else x[sl]
    bias = ops.bias
    if bias is not None:
        bias = bias[n0:n0 + n] if ep.bias_type == BiasType.ROW \
            else bias[m0:m0 + m, n0:n0 + n]
    return EpilogueOperands(
        bias=bias,
        scale_a=cut(ops.scale_a, slice(m0, m0 + m)),
        scale_b=cut(ops.scale_b, slice(n0, n0 + n)),
        residual=None if ops.residual is None
        else ops.residual[m0:m0 + m, n0:n0 + n])


def matmul_dep_tiles(graph: TaskGraph, node: Node) -> "list[Node]":
    """Matmul producers of ``node``, looking *through* memory nodes —
    a partitioned graph routes cross-unit edges via transfer nodes, but
    the data dependency is still on the producing tiles."""
    out: "list[Node]" = []
    seen: "set[int]" = set()
    stack = list(node.deps)
    while stack:
        d = stack.pop()
        if d in seen:
            continue
        seen.add(d)
        dn = graph.nodes[d]
        if dn.kind == "matmul":
            out.append(dn)
        elif dn.kind == "memory":
            stack.extend(dn.deps)
    return sorted(out, key=lambda n: n.nid)


def _epilogue_regions(graph: TaskGraph, policy, n_total: int):
    """Yield ``(ep, dep_tiles, (m_lo, m_hi, n_lo, n_hi))`` for each
    epilogue-carrying vector node, in program order, with the output
    dtype resolved and the GLU full-N guard applied — the one region
    walk both execution routes share."""
    for node in graph.topo_order():
        if node.kind != "vector" or node.epilogue is None:
            continue                          # cost-only node (sim graphs)
        ep = node.epilogue
        if ep.out_dtype is None:
            ep = dataclasses.replace(ep, out_dtype=policy.output_dtype)
        dep_tiles = matmul_dep_tiles(graph, node)
        m_lo = min(t.tile.m0 for t in dep_tiles)
        m_hi = max(t.tile.m0 + t.tile.m for t in dep_tiles)
        n_lo = min(t.tile.n0 for t in dep_tiles)
        n_hi = max(t.tile.n0 + t.tile.n for t in dep_tiles)
        if ep.glu and (n_lo != 0 or n_hi != n_total):
            raise ValueError("GLU epilogues need a full-N region; use "
                             "PANEL or LAYER granularity")
        yield ep, dep_tiles, (m_lo, m_hi, n_lo, n_hi)


def _place_region(out, part, ep, m_total: int, n_total: int,
                  m_lo: int, m_hi: int, n_lo: int):
    """Write one finished epilogue region into the output (allocated once,
    on the region's device, at the first region); GLU halves the column
    space."""
    if out is None:
        n_out = n_total // 2 if ep.glu else n_total
        out = torch.zeros((m_total, n_out), dtype=part.dtype,
                          device=part.device)
    col = n_lo // 2 if ep.glu else n_lo
    out[m_lo:m_hi, col:col + part.shape[-1]] = part
    return out


def _release(engine: AsyncMatmulEngine, handles: "dict[int, object]"):
    """Forget forced tile handles, so a graph of thousands of tiles does
    not hold their accumulators past the call."""
    ours = {id(h) for h in handles.values()}
    engine.dispatched[:] = [h for h in engine.dispatched
                            if id(h) not in ours]
    handles.clear()


def execute_graph_torch(graph: TaskGraph, a: torch.Tensor, b: torch.Tensor,
                        *, operands: EpilogueOperands = NO_OPERANDS,
                        engine: Optional[AsyncMatmulEngine] = None,
                        ) -> torch.Tensor:
    """Execute a single-GEMM TaskGraph on real tensors.

    Matrix nodes fire ``asyncMatMul`` (accumulator-precision tiles, no
    epilogue — the matrix unit's output); vector nodes force the handles
    they depend on (``checkMatmul``) and apply their ``Epilogue`` to the
    assembled region.  Node order is the graph's program order, so the
    schedule the DES times is the schedule the device runs.  Every tile
    is dispatched before the first is waited on; on CUDA operands each
    one launches on the engine's side stream.  ``b`` is 2-D ``(K, N)``
    (under a GLU epilogue: gate columns, then up columns).
    """
    engine = engine or AsyncMatmulEngine()
    policy = _infer_policy(a)
    tiles = graph.matmul_nodes()
    if not tiles:
        raise ValueError("graph has no matmul nodes")
    gemms = {t.layer for t in tiles}
    if len(gemms) > 1:
        raise ValueError(
            f"graph spans {len(gemms)} GEMMs ({sorted(gemms)[:3]}...); "
            "execute_graph_torch runs single-GEMM graphs — lower each "
            "layer GEMM separately")
    m_total = max(t.tile.m0 + t.tile.m for t in tiles)
    n_total = max(t.tile.n0 + t.tile.n for t in tiles)

    acc_ep = Epilogue(out_dtype=policy.accum_dtype)   # exact accumulators
    handles = {
        node.nid: engine.dispatch(            # asyncMatMul, program order
            node.task, a[node.tile.m0:node.tile.m0 + node.tile.m, :],
            b[:, node.tile.n0:node.tile.n0 + node.tile.n], epilogue=acc_ep)
        for node in graph.topo_order() if node.kind == "matmul"}
    # (memory nodes are simulation-only: nothing to execute.)
    out = None
    for ep, dep_tiles, (m_lo, m_hi, n_lo, n_hi) in \
            _epilogue_regions(graph, policy, n_total):
        region = torch.zeros((m_hi - m_lo, n_hi - n_lo),
                             dtype=policy.accum_dtype, device=a.device)
        for t in dep_tiles:
            acc = engine.wait(handles[t.nid])         # checkMatmul
            region[t.tile.m0 - m_lo:t.tile.m0 - m_lo + t.tile.m,
                   t.tile.n0 - n_lo:t.tile.n0 - n_lo + t.tile.n] = acc
        part = apply_epilogue(
            region, ep, _slice_operands(operands, ep, m_lo, m_hi - m_lo,
                                        n_lo, n_hi - n_lo))
        out = _place_region(out, part, ep, m_total, n_total, m_lo, m_hi,
                            n_lo)

    if out is None:                           # no epilogue nodes: raw acc
        out = torch.zeros((m_total, n_total), dtype=policy.accum_dtype,
                          device=a.device)
        for t in tiles:
            acc = engine.wait(handles[t.nid])
            out[t.tile.m0:t.tile.m0 + t.tile.m,
                t.tile.n0:t.tile.n0 + t.tile.n] = acc
        out = out.to(policy.output_dtype)
    _release(engine, handles)
    return out


def apply_graph_epilogues(graph: TaskGraph, acc: torch.Tensor, *,
                          operands: EpilogueOperands = NO_OPERANDS,
                          in_dtype=None) -> torch.Tensor:
    """Finish a single-GEMM graph from a *precomputed* full accumulator.

    Walks the same vector nodes ``execute_graph_torch`` would and applies
    their epilogues to the same regions, so a route that computes the
    whole accumulator at once (the reference's sharded backend) produces
    the same outputs.  ``in_dtype``: the operands' dtype, which picks the
    precision policy (default: ``acc``'s).
    """
    policy = _infer_policy(torch.zeros((), dtype=in_dtype)) \
        if in_dtype is not None else _infer_policy(acc)
    tiles = graph.matmul_nodes()
    if not tiles:
        raise ValueError("graph has no matmul nodes")
    m_total = max(t.tile.m0 + t.tile.m for t in tiles)
    n_total = max(t.tile.n0 + t.tile.n for t in tiles)
    out = None
    for ep, _, (m_lo, m_hi, n_lo, n_hi) in \
            _epilogue_regions(graph, policy, n_total):
        region = acc[m_lo:m_hi, n_lo:n_hi].to(policy.accum_dtype)
        part = apply_epilogue(
            region, ep, _slice_operands(operands, ep, m_lo, m_hi - m_lo,
                                        n_lo, n_hi - n_lo))
        out = _place_region(out, part, ep, m_total, n_total, m_lo, m_hi,
                            n_lo)
    if out is None:                           # no epilogue nodes: raw acc
        out = acc.to(policy.output_dtype)
    return out


def aggregate_cluster_workload(topology, layers: "list[LayerTrace]",
                               price_layer) -> "dict[str, float]":
    """Assemble the cluster workload dict (``simulate_workload`` shape
    plus cluster diagnostics) from any per-layer pricer.

    ``price_layer(layer)`` returns one *instance*'s
    ``{cycles, matrix, vector, ideal, loader_busy, transfers}``; repeat
    weighting and the utilization/seconds/flops tail live here so the
    DES pricer (:func:`cluster_workload`) and the analytical closed
    form agree on the aggregation by construction."""
    tot = {"cycles": 0.0, "matrix": 0.0, "vector": 0.0}
    ideal = 0.0
    loader_busy = 0.0
    transfers = 0
    for layer in layers:
        r = price_layer(layer)
        tot["cycles"] += r["cycles"] * layer.repeat
        tot["matrix"] += r["matrix"] * layer.repeat
        tot["vector"] += r["vector"] * layer.repeat
        ideal += r["ideal"] * layer.repeat
        loader_busy += r["loader_busy"] * layer.repeat
        transfers += r["transfers"]
    tot["seconds"] = tot["cycles"] / topology.unit.freq_hz
    tot["flops"] = sum(l.flops() for l in layers)
    tot["matrix_utilization"] = (
        ideal / (tot["cycles"] * topology.n_units) if tot["cycles"] else 0.0)
    tot["loader_utilization"] = (loader_busy / tot["cycles"]
                                 if tot["cycles"] else 0.0)
    tot["transfers"] = float(transfers)
    return tot


def cluster_workload(topology, layers: "list[LayerTrace]", *,
                     strategy: str = "row-panel",
                     fused: bool = True,
                     granularity: Granularity = Granularity.TILE,
                     affinity: "dict[str, int] | None" = None,
                     weights: "list[float] | None" = None,
                     ) -> "dict[str, float]":
    """``desim_workload`` on a cluster: per layer, partition the graph
    across the topology's units and simulate on the contended machine.
    ``affinity``/``weights`` reach the partitioner (the
    ``unit-affinity`` strategy), so workload pricing shards exactly
    like ``run_graph`` on the same backend."""
    from repro_torch.sim.desim import simulate_cluster, unit_prefix
    from repro_torch.sim.partition import partition_graph

    def price_layer(layer):
        graph, _ = layer_to_graph(topology.unit, layer, fused=fused,
                                  granularity=granularity,
                                  platform=topology.platform)
        part = partition_graph(graph, topology.n_units, strategy,
                               affinity=affinity, weights=weights)
        r = simulate_cluster(part.graph, topology)
        return {
            "cycles": r.cycles,
            "matrix": sum(r.busy(unit_prefix(i, r.n_units) + "pe_array")
                          for i in range(r.n_units)),
            "vector": sum(r.busy(unit_prefix(i, r.n_units)
                                 + "vector_unit")
                          for i in range(r.n_units)),
            "ideal": r.ideal_matrix_cycles,
            "loader_busy": r.loader_busy,
            "transfers": part.n_transfers,
        }

    return aggregate_cluster_workload(topology, layers, price_layer)


_STEP_GEMM_SUFFIX = re.compile(r"/g\d+$")


def step_label(node_layer: str) -> str:
    """Schedule-step name of a graph node's ``layer`` label — the
    ``LayerTrace.name`` before the per-GEMM ``/g<i>`` suffix
    ``workload_to_graph`` appends."""
    return _STEP_GEMM_SUFFIX.sub("", node_layer)


def step_spans(graph: TaskGraph, result) -> "dict[str, tuple[float, float]]":
    """Per-step ``(start, end)`` cycles of a simulated schedule graph.

    Groups ``result.node_span`` (a :class:`~repro_torch.sim.desim.DESimResult`)
    by :func:`step_label`, so a relaxed-overlap run shows directly which
    steps the DES actually overlapped — the measurement behind the
    cross-step-overlap acceptance pins."""
    out: "dict[str, tuple[float, float]]" = {}
    for node in graph.nodes:
        span = result.node_span.get(node.nid)
        if span is None:
            continue
        key = step_label(node.layer)
        cur = out.get(key)
        out[key] = span if cur is None else (min(cur[0], span[0]),
                                             max(cur[1], span[1]))
    return out


def offset_step_spans(spans: "dict[str, tuple[float, float]]",
                      offset: float) -> "dict[str, tuple[float, float]]":
    """Shift per-step ``(start, end)`` windows by ``offset`` cycles —
    an admission epoch's DES run starts its clock at 0, so the online
    loop adds the epoch's global start before folding the windows into
    the cross-epoch span log."""
    return {k: (s + offset, e + offset) for k, (s, e) in spans.items()}


def gemm_labels(graph: TaskGraph) -> "list[str]":
    """Distinct GEMM labels of a graph, in program order.  One label per
    ``build_gemm_graph`` call — for a ``workload_to_graph`` schedule that
    is ``f"{layer.name}/g{gemm_index}"``."""
    seen: "list[str]" = []
    for n in graph.matmul_nodes():
        if n.layer not in seen:
            seen.append(n.layer)
    return seen


def _subgraph_for_gemm(graph: TaskGraph, label: str) -> TaskGraph:
    """Extract one GEMM from a schedule graph as a standalone single-GEMM
    graph (nids remapped, cross-layer scheduling deps dropped).

    Epilogue-carrying vector nodes come along when all their matrix deps
    belong to the GEMM; LAYER-granularity epilogues spanning several
    GEMMs cannot be executed per-GEMM and are left behind (the caller
    gets raw accumulator outputs for those GEMMs).
    """
    sub = TaskGraph()
    remap: "dict[int, int]" = {}
    for node in graph.nodes:
        if node.kind == "matmul" and node.layer == label:
            remap[node.nid] = sub.add(
                "matmul", node.name, layer=node.layer, unit=node.unit,
                task=node.task, tile=node.tile).nid
        elif node.kind == "vector" and node.epilogue is not None:
            mdeps = [t.nid for t in matmul_dep_tiles(graph, node)]
            if mdeps and all(d in remap for d in mdeps):
                sub.add("vector", node.name,
                        deps=tuple(remap[d] for d in mdeps),
                        layer=node.layer, unit=node.unit,
                        vector_ops=dict(node.vector_ops),
                        epilogue=node.epilogue)
    return sub


def iter_gemm_operands(graph: TaskGraph, operands: "dict[str, object]"):
    """Validate + normalise a ``{gemm label: operands}`` dict against a
    schedule graph; yields ``(label, a, b, epilogue_operands)`` in
    schedule order.  Accepted per-GEMM forms: an ``(a, b)`` tuple, an
    ``(a, b, EpilogueOperands)`` triple, or any object with ``.a``/
    ``.b`` (and optionally ``.epilogue``) attributes such as
    ``repro_torch.backend.MatMulOperands``.  GEMMs without operands are
    skipped (a schedule may be only partially concrete)."""
    labels = gemm_labels(graph)
    unknown = set(operands) - set(labels)
    if unknown:
        raise KeyError(
            f"operands for unknown GEMM labels {sorted(unknown)[:4]}; "
            f"graph has {labels[:4]}...")
    for label in labels:
        ops = operands.get(label)
        if ops is None:
            continue
        if isinstance(ops, (tuple, list)):
            a, b = ops[0], ops[1]
            eops = ops[2] if len(ops) > 2 else NO_OPERANDS
        else:
            a, b = ops.a, ops.b
            eops = getattr(ops, "epilogue", NO_OPERANDS)
        yield label, a, b, eops


def execute_workload_torch(graph: TaskGraph, operands: "dict[str, object]",
                           *, engine: Optional[AsyncMatmulEngine] = None,
                           ) -> "dict[str, torch.Tensor]":
    """Execute a multi-GEMM schedule TaskGraph on real tensors.

    ``operands`` maps a GEMM label (see :func:`gemm_labels`) to its
    tensors (the forms :func:`iter_gemm_operands` accepts).  Each GEMM is
    executed through :func:`execute_graph_torch` in schedule order.
    Returns ``{label: output tensor}``.
    """
    engine = engine or AsyncMatmulEngine()
    outs: "dict[str, torch.Tensor]" = {}
    for label, a, b, eops in iter_gemm_operands(graph, operands):
        outs[label] = execute_graph_torch(
            _subgraph_for_gemm(graph, label), a, b, operands=eops,
            engine=engine)
    return outs


# ---------------------------------------------------------------------------
# Epilogue -> abstract Saturn costs, so one graph carries both payloads.
# ---------------------------------------------------------------------------

def epilogue_vector_ops(ep: Epilogue, m: int, n: int) -> "dict[str, float]":
    """First-order Saturn cost of applying ``ep`` to an (m, n) tile —
    lets ``build_gemm_graph`` attach both the execution payload and the sim
    cost to the same vector nodes."""
    elems = float(m * n)
    ops: "dict[str, float]" = {}

    def add(op, n_el):
        ops[op] = ops.get(op, 0.0) + n_el

    if ep.has_scale_a or ep.has_scale_b:
        add("dequant", elems)
    if ep.bias_type != BiasType.ZERO:
        add("bias", elems)
    if ep.softcap:
        add("softcap", elems)
    act_elems = elems / 2 if ep.glu else elems
    if ep.activation != "none":
        add(ep.activation if ep.activation in VECTOR_OP_INSTRS else
            "eltwise_misc", act_elems)
    if ep.glu:
        add("glu_mul", elems / 2)
    if ep.has_residual:
        add("residual", act_elems if ep.glu else elems)
    if not ops:
        add("copy", elems)
    return ops
