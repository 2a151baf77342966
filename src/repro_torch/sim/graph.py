"""TaskGraph IR — the unified representation of asynchronous execution.

A ``TaskGraph`` is a DAG of ``Node``s.  Three node kinds mirror the
three hardware streams of the paper's microarchitecture:

* ``matmul`` — one ``asyncMatMul`` tile task (paper Table 1 / Listing 1):
  a :class:`~repro_torch.core.task.MatMulTask` sub-problem plus the
  coordinates
  of the tile inside its parent GEMM.  Produced by ``tile_tasks``.
* ``vector`` — Saturn vector-unit work: either abstract op→element-count
  costs (for simulation) or an :class:`~repro_torch.core.fusion.Epilogue`
  (for execution), usually both.
* ``memory`` — bulk DRAM traffic with no compute (the unfused
  intermediate round-trip).

``Granularity`` configures how much vector work rides behind each
synchronisation point — the "flexible granularity" axis of the paper's
async abstraction:

* ``TILE``  — one epilogue node per matrix tile (Listing 1, max overlap);
* ``PANEL`` — one epilogue node per row-panel of tiles;
* ``LAYER`` — one epilogue node after the whole GEMM (no overlap, but
  still skips the DRAM round-trip).

The same graph is consumed by ``sim.desim`` (resource-level discrete-
event simulation) and ``sim.lower.execute_graph_torch`` (execution through
``AsyncMatmulEngine``/``cute_matmul``).  A copy of the reference's
``repro/sim/graph.py``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

from repro_torch.core.task import MatMulTask, tile_tasks


class Granularity(str, enum.Enum):
    TILE = "tile"
    PANEL = "panel"
    LAYER = "layer"


@dataclasses.dataclass(frozen=True)
class TileCoord:
    """Placement of a tile inside its parent GEMM (row-major order)."""

    m0: int
    n0: int
    m: int
    n: int


@dataclasses.dataclass
class Node:
    """One schedulable unit.  ``deps`` are node ids that must complete
    before this node may start."""

    nid: int
    kind: str                         # "matmul" | "vector" | "memory"
    name: str
    deps: "tuple[int, ...]" = ()
    layer: str = ""                   # grouping label for traces
    unit: int = 0                     # matrix unit this node runs on
    #: earliest simulated cycle this node may start, independent of its
    #: deps — how request arrival times reach the machine model (a node
    #: whose deps finish earlier simply waits in the queue until then).
    release_time: float = 0.0
    # matmul payload
    task: Optional[MatMulTask] = None
    tile: Optional[TileCoord] = None
    # vector payload — abstract costs and/or a concrete epilogue
    vector_ops: "dict[str, float]" = dataclasses.field(default_factory=dict)
    epilogue: object = None           # fusion.Epilogue for execution
    # memory payload
    mem_bytes: float = 0.0


class TaskGraph:
    """Append-only DAG; nids are dense ints in insertion (program) order."""

    def __init__(self):
        self.nodes: "list[Node]" = []

    def __len__(self) -> int:
        return len(self.nodes)

    def add(self, kind: str, name: str, deps=(), **payload) -> Node:
        for d in deps:
            if not 0 <= d < len(self.nodes):
                raise ValueError(f"dep {d} of {name!r} does not exist yet")
        node = Node(nid=len(self.nodes), kind=kind, name=name,
                    deps=tuple(deps), **payload)
        self.nodes.append(node)
        return node

    # Appending can only reference earlier nids, so insertion order *is* a
    # topological order; ``topo_order`` re-checks in case deps were edited.
    def topo_order(self) -> "list[Node]":
        seen = set()
        for node in self.nodes:
            for d in node.deps:
                if d not in seen:
                    raise ValueError(
                        f"node {node.nid} ({node.name!r}) depends on {d} "
                        "which is not earlier in program order")
            seen.add(node.nid)
        return list(self.nodes)

    def matmul_nodes(self) -> "list[Node]":
        return [n for n in self.nodes if n.kind == "matmul"]

    def vector_nodes(self) -> "list[Node]":
        return [n for n in self.nodes if n.kind == "vector"]

    def sinks(self) -> "list[Node]":
        used = {d for n in self.nodes for d in n.deps}
        return [n for n in self.nodes if n.nid not in used]

    def stats(self) -> "dict[str, int]":
        out = {"nodes": len(self.nodes), "matmul": 0, "vector": 0,
               "memory": 0, "edges": 0}
        for n in self.nodes:
            out[n.kind] += 1
            out["edges"] += len(n.deps)
        return out


def group_tiles(tiles: "list[Node]", granularity: Granularity,
                n: int, tile_n: int) -> "list[list[Node]]":
    """Group one GEMM's tile nodes (row-major order) per the granularity:
    singletons (TILE), rows of ceil(n/tile_n) tiles (PANEL), or all
    together (LAYER)."""
    if granularity == Granularity.TILE:
        return [[t] for t in tiles]
    if granularity == Granularity.PANEL:
        n_cols = max(1, -(-n // tile_n))
        return [tiles[i:i + n_cols] for i in range(0, len(tiles), n_cols)]
    return [tiles]


def _tile_coords(task: MatMulTask, tile_m: int, tile_n: int):
    """Tile coordinates in the exact order ``tile_tasks`` emits them."""
    for m0 in range(0, task.m, tile_m):
        for n0 in range(0, task.n, tile_n):
            yield TileCoord(m0, n0, min(tile_m, task.m - m0),
                            min(tile_n, task.n - n0))


def build_gemm_graph(task: MatMulTask, tile_m: int, tile_n: int, *,
                     graph: Optional[TaskGraph] = None,
                     deps=(), layer: str = "gemm",
                     granularity: Granularity = Granularity.TILE,
                     vector_ops: "dict[str, float] | None" = None,
                     epilogue=None) -> "tuple[TaskGraph, list[Node]]":
    """Tile one logical matmul into a dependency-linked task graph.

    Matrix tiles come from ``tile_tasks`` (the asyncMatMul macro).  If
    ``vector_ops``/``epilogue`` is given, vector nodes are attached at the
    requested granularity, with the abstract cost split evenly across
    them.  Returns ``(graph, sink_nodes)`` — the nodes a successor layer
    must depend on.
    """
    graph = graph if graph is not None else TaskGraph()
    subtasks = tile_tasks(task, tile_m, tile_n)
    coords = list(_tile_coords(task, tile_m, tile_n))
    assert len(subtasks) == len(coords)

    tiles = [graph.add("matmul", f"{layer}/t{c.m0//tile_m},{c.n0//tile_n}",
                       deps=deps, layer=layer, task=sub, tile=c)
             for sub, c in zip(subtasks, coords)]
    if vector_ops is None and epilogue is None:
        return graph, tiles

    groups = group_tiles(tiles, granularity, task.n, tile_n)
    share = {op: n / len(groups) for op, n in (vector_ops or {}).items()}
    vecs = [graph.add("vector", f"{layer}/vec{i}",
                      deps=tuple(t.nid for t in grp), layer=layer,
                      vector_ops=dict(share), epilogue=epilogue)
            for i, grp in enumerate(groups)]
    return graph, vecs
