"""TaskGraph partitioner: shard matmul work across cluster units.

``partition_graph`` rewrites a (single- or multi-GEMM) TaskGraph so
every node carries a ``unit`` placement and every producer→consumer edge
that crosses units goes through an explicit **transfer node** — a
``memory`` node occupying the shared loader for the producer's output
bytes.  Three strategies, the classic GEMM-sharding axes:

* ``row-panel`` — contiguous blocks of M row-panels per unit.  Each unit
  owns full output rows, so per-panel epilogues stay unit-local; the
  cluster mirror of Megatron row parallelism (and of
  ``distributed.collective_matmul``'s X-sharding).
* ``output-tile`` — contiguous blocks of N tile-columns per unit.  Each
  unit owns full output columns (B sharded, A replicated); GLU/full-N
  epilogues force gather transfers.
* ``layer-pipeline`` — whole GEMMs round-robin across units; inter-layer
  activations cross units as transfers, the pipeline-parallel layout.
* ``unit-affinity`` — whole GEMMs placed by a serving policy's
  per-request affinity hints (``affinity={layer or GEMM label: unit}``),
  with unhinted GEMMs balanced greedily onto the least-loaded unit
  under per-unit ``weights`` (relative throughput — heterogeneous
  clusters want MACs routed in proportion to PE width, not round-robin).
  The co-optimisation seam between ``serving.scheduler`` batching
  policies and shard placement.

Why transfers are charged the way they are: in this machine model every
tile load/writeback already moves through shared DRAM, so a same-unit
dependent pays nothing extra (the data is conceptually still warm in the
unit's scratchpad/L2).  A *cross-unit* dependent, however, must wait for
the producer's bytes to actually land in shared memory and be re-read —
the DES's fire-and-forget writeback no longer hides it.  The transfer
node makes that synchronisation explicit and puts its bytes on the
shared loader, which is exactly the contention term multi-unit studies
(CAMP, arXiv 2504.08137) identify.

The *same* partitioned graph is consumed by ``sim.desim
.simulate_cluster`` (contended timelines) and, in the reference, by the
``sharded`` backend (``shard_map`` execution over a ``units`` mesh axis),
which the port has not carried over yet.  A copy of the reference's
``repro/sim/partition.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.sim.graph import Node, TaskGraph

STRATEGIES = ("row-panel", "output-tile", "layer-pipeline",
              "unit-affinity")

#: strategy -> GEMM dimension it shards (None: whole GEMMs per unit).
#: The simulation and execution halves must agree on this axis.
STRATEGY_DIM = {"row-panel": "m", "output-tile": "n",
                "layer-pipeline": None, "unit-affinity": None}

#: accumulator bytes per output element (resident C is fp32/int32).
ACC_BYTES = 4.0


@dataclasses.dataclass
class Partition:
    """A partitioned graph plus the metadata execution backends need."""

    graph: TaskGraph
    n_units: int
    strategy: str
    #: new-graph nid -> unit (matches ``Node.unit``; kept for reporting)
    assignment: "dict[int, int]"
    #: row-panel/output-tile: gemm label -> per-unit (lo, hi) extents
    #: along the sharded dim (M rows or N cols); None for idle units.
    spans: "dict[str, list[Optional[tuple[int, int]]]]"
    #: layer-pipeline: gemm label -> owning unit.
    unit_of_label: "dict[str, int]"
    n_transfers: int
    transfer_bytes: float

    @property
    def shard_dim(self) -> Optional[str]:
        return STRATEGY_DIM[self.strategy]

    def balanced(self, label: str) -> bool:
        """True when every unit owns an equally-sized contiguous span of
        ``label`` — the precondition for one ``shard_map`` over the
        whole GEMM (otherwise execution falls back to per-unit slices)."""
        spans = self.spans.get(label)
        if not spans or any(s is None for s in spans):
            return False
        sizes = {hi - lo for lo, hi in spans}
        return len(sizes) == 1


def _matmul_area(graph: TaskGraph, node: Node) -> float:
    """Output elements a node produces (transitively, through memory
    nodes, for vector regions)."""
    if node.kind == "matmul":
        return float(node.tile.m * node.tile.n) if node.tile else \
            float(node.task.m * node.task.n)
    area = 0.0
    for d in node.deps:
        area += _matmul_area(graph, graph.nodes[d])
    return area


def _affinity_placement(label_order: "list[str]",
                        by_label: "dict[str, list[Node]]",
                        n_units: int,
                        affinity: "dict[str, int] | None",
                        weights: "list[float] | None",
                        ) -> "dict[str, int]":
    """Whole-GEMM placement for ``unit-affinity``: honour hints first,
    then greedily put each unhinted GEMM on the unit with the lowest
    *normalised* load (cumulative MACs / throughput weight)."""
    affinity = affinity or {}
    if weights is None:
        weights = [1.0] * n_units
    if len(weights) != n_units or any(w <= 0 for w in weights):
        raise ValueError(
            f"weights must be {n_units} positive per-unit throughputs; "
            f"got {weights}")
    load = [0.0] * n_units

    def hint_for(lbl: str):
        # a hint may name the GEMM label ("step/g2") or its whole
        # layer/step ("step" — what a serving policy emits per step).
        if lbl in affinity:
            return affinity[lbl]
        head = lbl.rsplit("/g", 1)[0]
        return affinity.get(head)

    placement: "dict[str, int]" = {}
    for lbl in label_order:
        macs = sum(t.task.macs for t in by_label[lbl])
        hint = hint_for(lbl)
        if hint is not None:
            if not 0 <= hint < n_units:
                raise ValueError(
                    f"affinity hint {hint} for {lbl!r} out of range for "
                    f"{n_units} unit(s)")
            u = hint
        else:
            u = min(range(n_units),
                    key=lambda i: ((load[i] + macs) / weights[i], i))
        placement[lbl] = u
        load[u] += macs
    return placement


def partition_graph(graph: TaskGraph, n_units: int,
                    strategy: str = "row-panel", *,
                    affinity: "dict[str, int] | None" = None,
                    weights: "list[float] | None" = None) -> Partition:
    """Rewrite ``graph`` with per-node unit placements + transfer nodes.

    ``n_units == 1`` returns a copy with everything on unit 0 and no
    transfers (the degenerate cluster).  ``affinity``/``weights`` feed
    the ``unit-affinity`` strategy (and are ignored by the others):
    per-label placement hints from a serving policy, and relative
    per-unit throughputs for balancing the rest.
    """
    if strategy not in STRATEGIES:
        raise ValueError(
            f"unknown partition strategy {strategy!r}; one of {STRATEGIES}")
    if n_units < 1:
        raise ValueError(f"n_units must be >= 1, got {n_units}")

    nodes = graph.topo_order()
    # Per-GEMM geometry for the spatial strategies.
    by_label: "dict[str, list[Node]]" = {}
    for n in nodes:
        if n.kind == "matmul":
            by_label.setdefault(n.layer, []).append(n)
    label_order = list(by_label)
    if strategy == "unit-affinity":
        unit_of_label = _affinity_placement(label_order, by_label, n_units,
                                            affinity, weights)
    else:
        unit_of_label = {lbl: i % n_units
                         for i, lbl in enumerate(label_order)}

    panel_unit: "dict[str, dict[int, int]]" = {}   # label -> {m0/n0 -> unit}
    spans: "dict[str, list[Optional[tuple[int, int]]]]" = {}
    if strategy in ("row-panel", "output-tile"):
        for lbl, tiles in by_label.items():
            key = (lambda t: t.tile.m0) if strategy == "row-panel" \
                else (lambda t: t.tile.n0)
            ext = (lambda t: t.tile.m) if strategy == "row-panel" \
                else (lambda t: t.tile.n)
            starts = sorted({key(t) for t in tiles})
            n_panels = len(starts)
            panel_unit[lbl] = {
                s: min(i * n_units // n_panels, n_units - 1)
                for i, s in enumerate(starts)}
            per_unit: "list[Optional[tuple[int, int]]]" = [None] * n_units
            for t in tiles:
                u = panel_unit[lbl][key(t)]
                lo, hi = key(t), key(t) + ext(t)
                cur = per_unit[u]
                per_unit[u] = (lo, hi) if cur is None else \
                    (min(cur[0], lo), max(cur[1], hi))
            spans[lbl] = per_unit

    def assign(node: Node) -> int:
        if STRATEGY_DIM[strategy] is None:     # whole-GEMM placements
            return unit_of_label[node.layer]
        key = node.tile.m0 if strategy == "row-panel" else node.tile.n0
        return panel_unit[node.layer][key]

    out = TaskGraph()
    remap: "dict[int, int]" = {}
    unit_of: "dict[int, int]" = {}        # new nid -> unit
    xfers: "dict[tuple[int, int], int]" = {}   # (old nid, unit) -> new nid
    n_transfers = 0
    transfer_bytes = 0.0

    def dep_for(old_dep: int, consumer_unit: int) -> int:
        nonlocal n_transfers, transfer_bytes
        prod = graph.nodes[old_dep]
        new_dep = remap[old_dep]
        if prod.kind == "memory" or unit_of[new_dep] == consumer_unit:
            # memory nodes already live in shared DRAM — no extra hop.
            return new_dep
        key = (old_dep, consumer_unit)
        if key not in xfers:
            nbytes = _matmul_area(graph, prod) * ACC_BYTES
            t = out.add("memory",
                        f"{prod.name}/xfer@u{consumer_unit}",
                        deps=(new_dep,), layer=prod.layer,
                        unit=consumer_unit, mem_bytes=nbytes)
            unit_of[t.nid] = consumer_unit
            xfers[key] = t.nid
            n_transfers += 1
            transfer_bytes += nbytes
        return xfers[key]

    for node in nodes:
        if node.kind == "matmul":
            u = assign(node)
        elif node.deps:
            # vector/memory nodes co-locate with their first producer
            # (ties epilogues to the unit that computed the panel).
            first = remap[node.deps[0]]
            u = unit_of[first]
        else:
            u = 0
        deps = tuple(dep_for(d, u) for d in node.deps)
        new = out.add(node.kind, node.name, deps=deps, layer=node.layer,
                      unit=u, task=node.task, tile=node.tile,
                      release_time=node.release_time,
                      vector_ops=dict(node.vector_ops),
                      epilogue=node.epilogue, mem_bytes=node.mem_bytes)
        remap[node.nid] = new.nid
        unit_of[new.nid] = u

    return Partition(graph=out, n_units=n_units, strategy=strategy,
                     assignment=unit_of, spans=spans,
                     unit_of_label=unit_of_label, n_transfers=n_transfers,
                     transfer_bytes=transfer_bytes)
