"""Discrete-event execution of a TaskGraph on an explicit machine model.

Where ``core.simulator`` asserts the overlap with a closed-form
``max(matrix, vec)``, this module *derives* it: every node of the graph
contends for explicit resources and the timeline falls out of the event
schedule.

Machine resources (paper §4.1/§4.4), per matrix unit:

* ``dispatcher`` — the CPU front-end.  Every ``asyncMatMul`` occupies it
  for ``platform.dispatch_cycles`` (RoCC few tens, CSR ~100, Table 3)
  and every completion poll for ``platform.check_cycles``.  It is a
  single serial resource: a slow interface genuinely backpressures the
  tile stream instead of being a term in a max().
* ``banks`` — the double-buffered scratchpad: ``unit.scratchpad_banks``
  slots, each held for a tile's load+compute span.  Two banks is what
  lets tile *i+1*'s load overlap tile *i*'s compute.
* ``pe`` — the M_pe×N_pe array; a tile occupies it for the Eq.1 compute
  time with PE-quantised extents, plus a six-stage pipeline drain on the
  result latency.
* ``vector`` — the Saturn RVV unit running epilogue nodes.

and shared across the cluster:

* ``loader`` — streams A/B panels in and the C tile out.  A
  :class:`~repro_torch.sim.resources.ClusterTopology` decides how many units
  contend for it and under which bandwidth-partitioning policy
  (``fair`` processor sharing vs ``fcfs``); the single-unit machine is
  the ``n_units=1, fcfs`` special case.

A matmul node's life: dispatch → wait for a scratchpad bank → load →
compute → (writeback ‖ status poll) → dependents released.  With
``k_stream`` enabled the load arrives in ``k_scp``-sized chunks and the
PE starts after the first chunk, overlapping a single tile's fill with
its own compute (DES-fidelity ROADMAP item).  Vector and memory nodes
occupy their single resource for their modelled duration.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.core.config import MatrixUnitConfig
from repro_torch.core.hardware import CpuPlatform, SHUTTLE
from repro_torch.core.precision import policy
from repro_torch.core.simulator import SATURN_512, VectorUnit
from repro_torch.core.task import BiasType
from repro_torch.sim.graph import Node, TaskGraph
from repro_torch.sim.resources import (BandwidthResource, ClusterTopology,
                                       EventLoop, Resource,
                                       contiguous_run_bytes,
                                       dram_stride_efficiency)


@dataclasses.dataclass
class Machine:
    """The resource set one (unit, platform, vector) triple implies.

    Retained as the single-unit cost-model context (``tile_costs``, the
    analytical backend); simulation itself runs on :class:`ClusterMachine`.
    """

    loop: EventLoop
    unit: MatrixUnitConfig
    platform: CpuPlatform
    vector_unit: VectorUnit
    dispatcher: Resource
    loader: Resource
    banks: Resource
    pe: Resource
    vector: Resource

    @property
    def bytes_per_cycle(self) -> float:
        return (self.unit.bandwidth * self.platform.dram_efficiency
                / self.unit.freq_hz)

    def resources(self) -> "list[Resource]":
        return [self.dispatcher, self.loader, self.banks, self.pe,
                self.vector]


def build_machine(unit: MatrixUnitConfig, platform: CpuPlatform,
                  vector_unit: VectorUnit = SATURN_512) -> Machine:
    loop = EventLoop()
    return Machine(
        loop=loop, unit=unit, platform=platform, vector_unit=vector_unit,
        dispatcher=Resource(loop, "dispatcher"),
        loader=Resource(loop, "mem_loader"),
        banks=Resource(loop, "scratchpad", capacity=unit.scratchpad_banks),
        pe=Resource(loop, "pe_array"),
        vector=Resource(loop, "vector_unit"),
    )


# ---------------------------------------------------------------------------
# Per-node cost model (mirrors core.simulator.simulate_gemm's per-tile terms).
# ---------------------------------------------------------------------------

def tile_work(unit: MatrixUnitConfig, platform: CpuPlatform, node: Node,
              out_bytes: float = 4.0,
              streams: int = 1) -> "dict[str, float]":
    """Per-tile compute cycles and *effective* load/writeback bytes.

    Effective bytes are actual bytes divided by the stride-dependent DRAM
    efficiency the operand's access pattern achieves (``Task`` strides,
    paper §5.4) — a dense panel streams at the platform's calibrated
    derate, a narrow tile cut from a wide row-major matrix pays per-row
    address jumps.  Dividing by a loader's raw bytes/cycle turns them
    into cycles, which is how the shared cluster loader charges them.

    ``streams`` is the row-buffer interleaving factor
    (``ClusterTopology.interleaved_streams``): tiles riding a shared
    pool alongside ``streams - 1`` other units see their contiguous runs
    chopped accordingly; 1 (default, and any private slice) keeps the
    single-stream curve.
    """
    task = node.task
    base = platform.dram_efficiency
    dt = task.data_type
    eb = policy(dt).bytes_per_elem
    m_eff = -(-task.m // unit.m_pe) * unit.m_pe
    n_eff = -(-task.n // unit.n_pe) * unit.n_pe
    kpe = unit.k_pe_elems(dt)
    k_eff = -(-task.k // kpe) * kpe
    compute = m_eff * n_eff * k_eff / unit.macs_per_cycle(dt)
    bias_bytes = {BiasType.ZERO: 0.0, BiasType.ROW: task.n * 4.0,
                  BiasType.FULL: task.m * task.n * 4.0}[task.bias_type]
    eff_a = dram_stride_efficiency(
        contiguous_run_bytes(task.m, task.k, task.stride_a, eb), base,
        streams)
    eff_b = dram_stride_efficiency(
        contiguous_run_bytes(task.k, task.n, task.stride_b, eb), base,
        streams)
    eff_c = dram_stride_efficiency(
        contiguous_run_bytes(task.m, task.n, task.stride_c, out_bytes),
        base, streams)
    load_eff = (task.m * task.k * eb / eff_a
                + task.k * task.n * eb / eff_b
                + bias_bytes / base)
    wb_eff = task.m * task.n * out_bytes / eff_c
    return {"compute": compute, "load_eff": load_eff, "wb_eff": wb_eff,
            "eff_a": eff_a, "eff_b": eff_b, "bias_eff": bias_bytes / base}


def tile_costs(machine: Machine, node: Node,
               out_bytes: float = 4.0) -> "dict[str, float]":
    """Per-tile compute/load/writeback cycles on a dedicated loader at
    ``unit.bandwidth`` (the single-unit machine; the analytical backend's
    cost source)."""
    w = tile_work(machine.unit, machine.platform, node, out_bytes)
    raw_bpc = machine.unit.bandwidth / machine.unit.freq_hz
    return {"compute": w["compute"], "load": w["load_eff"] / raw_bpc,
            "writeback": w["wb_eff"] / raw_bpc}


def tile_chunks(unit: MatrixUnitConfig, platform: CpuPlatform, node: Node,
                out_bytes: float = 4.0,
                streams: int = 1) -> "list[tuple[float, float]]":
    """K-chunked (load_eff_bytes, compute_cycles) stream for one tile.

    The scratchpad stages ``k_scp_bytes`` of the K extent at a time; the
    PE may reduce chunk *j* as soon as chunk *j* is resident, so a
    tile's fill overlaps its own compute.  Bias rides the first chunk.
    ``streams`` is the row-buffer interleaving factor (see
    :func:`tile_work`).
    """
    task = node.task
    w = tile_work(unit, platform, node, out_bytes, streams)
    dt = task.data_type
    eb = policy(dt).bytes_per_elem
    ck = max(1, int(unit.k_scp_bytes / eb))
    if task.k <= ck:
        return [(w["load_eff"], w["compute"])]
    m_eff = -(-task.m // unit.m_pe) * unit.m_pe
    n_eff = -(-task.n // unit.n_pe) * unit.n_pe
    kpe = unit.k_pe_elems(dt)
    macs = unit.macs_per_cycle(dt)
    chunks = []
    k0 = 0
    while k0 < task.k:
        kc = min(ck, task.k - k0)
        load = (task.m * kc * eb / w["eff_a"]
                + kc * task.n * eb / w["eff_b"])
        if k0 == 0:
            load += w["bias_eff"]
        compute = m_eff * n_eff * (-(-kc // kpe) * kpe) / macs
        chunks.append((load, compute))
        k0 += kc
    return chunks


# ---------------------------------------------------------------------------
# Cluster machine: N units behind one shared loader.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class UnitMachine:
    """One matrix unit's private resources inside a cluster.

    ``config`` is the unit's own :class:`MatrixUnitConfig` (heterogeneous
    clusters mix them); ``private_loader`` is the unit's dedicated
    bandwidth slice when the topology carves one out of the pool —
    ``None`` means the unit's traffic contends on the shared loader.
    """

    idx: int
    prefix: str                       # "" for a 1-unit cluster, "u0/" etc.
    config: MatrixUnitConfig
    dispatcher: Resource
    banks: Resource
    pe: Resource
    vector: Resource
    private_loader: Optional[BandwidthResource] = None
    private_bpc: float = 0.0          # raw bytes/cycle of the private slice

    def resources(self) -> "list[Resource]":
        return [self.dispatcher, self.banks, self.pe, self.vector]


@dataclasses.dataclass
class ClusterMachine:
    loop: EventLoop
    topology: ClusterTopology
    units: "list[UnitMachine]"
    loader: BandwidthResource

    @property
    def loader_bpc(self) -> float:
        """Raw *contended-pool* loader bytes/cycle: the pooled bandwidth
        minus private slices (derates are per-transfer)."""
        return self.topology.shared_bandwidth / self.topology.unit.freq_hz

    @property
    def memory_node_bpc(self) -> float:
        """Bytes/cycle a bulk memory node achieves (flat platform derate,
        mirroring the single-unit ``Machine.bytes_per_cycle``)."""
        return self.loader_bpc * self.topology.platform.dram_efficiency


def unit_prefix(idx: int, n_units: int) -> str:
    return "" if n_units == 1 else f"u{idx}/"


def build_cluster(topology: ClusterTopology) -> ClusterMachine:
    loop = EventLoop()
    freq = topology.unit.freq_hz
    units = []
    for i in range(topology.n_units):
        p = unit_prefix(i, topology.n_units)
        cfg = topology.unit_config(i)
        private = topology.private_bandwidth(i)
        units.append(UnitMachine(
            idx=i, prefix=p, config=cfg,
            dispatcher=Resource(loop, p + "dispatcher"),
            banks=Resource(loop, p + "scratchpad",
                           capacity=cfg.scratchpad_banks),
            pe=Resource(loop, p + "pe_array"),
            vector=Resource(loop, p + "vector_unit"),
            private_loader=BandwidthResource(loop, p + "local_loader",
                                             policy="fcfs")
            if private > 0 else None,
            private_bpc=private / freq))
    loader = BandwidthResource(loop, "mem_loader",
                               policy=topology.loader_policy)
    return ClusterMachine(loop=loop, topology=topology, units=units,
                          loader=loader)


# ---------------------------------------------------------------------------
# Results.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DESimResult:
    cycles: float                       # makespan
    ideal_matrix_cycles: float          # Eq.1 lower bound for all matmul work
    node_span: "dict[int, tuple[float, float]]"   # nid -> (start, end)
    intervals: "dict[str, list[tuple[float, float, str]]]"
    capacity: "dict[str, int]"
    freq_hz: float

    @property
    def matrix_utilization(self) -> float:
        return (self.ideal_matrix_cycles / self.cycles) if self.cycles else 0.0

    def busy(self, resource: str) -> float:
        return sum(e - s for s, e, _ in self.intervals[resource])

    def utilization(self, resource: str) -> float:
        if not self.cycles:
            return 0.0
        return self.busy(resource) / (self.cycles * self.capacity[resource])

    def utilizations(self) -> "dict[str, float]":
        return {r: self.utilization(r) for r in self.intervals}

    def seconds(self) -> float:
        return self.cycles / self.freq_hz


@dataclasses.dataclass
class ClusterDESimResult(DESimResult):
    """Per-unit timelines + shared-loader contention of a cluster run.

    ``intervals["mem_loader"]`` holds per-transfer spans (overlapping
    under the ``fair`` policy — that overlap *is* the visible
    contention); ``loader_busy`` is the union busy time, which is what
    loader utilization/saturation is judged on.
    """

    n_units: int = 1
    loader_busy: float = 0.0
    topology: Optional[ClusterTopology] = None

    @property
    def aggregate_matrix_utilization(self) -> float:
        """Ideal unit-cycles over makespan × cluster width — 1.0 means
        every PE array busy with useful MACs the whole run."""
        if not self.cycles:
            return 0.0
        return self.ideal_matrix_cycles / (self.cycles * self.n_units)

    @property
    def loader_utilization(self) -> float:
        return (self.loader_busy / self.cycles) if self.cycles else 0.0

    def utilization(self, resource: str) -> float:
        if resource == "mem_loader":
            return self.loader_utilization
        return super().utilization(resource)

    def unit_utilizations(self) -> "list[float]":
        """Per-unit PE-array busy fraction."""
        out = []
        for i in range(self.n_units):
            name = unit_prefix(i, self.n_units) + "pe_array"
            out.append(self.busy(name) / self.cycles if self.cycles else 0.0)
        return out

    def loader_contention(self) -> float:
        """Σ transfer spans / union busy — 1.0 means no two transfers
        ever overlapped; higher means the fair-share loader was split."""
        demand = sum(e - s for s, e, _ in self.intervals["mem_loader"])
        return demand / self.loader_busy if self.loader_busy else 0.0


# ---------------------------------------------------------------------------
# The discrete-event engine.
# ---------------------------------------------------------------------------

def simulate_cluster(graph: TaskGraph,
                     topology: ClusterTopology) -> ClusterDESimResult:
    """Run ``graph`` on a cluster machine; per-unit timelines + contention.

    Node placement comes from ``Node.unit`` (see ``sim.partition``); an
    unpartitioned graph runs entirely on unit 0.
    """
    nodes = graph.topo_order()
    machine = build_cluster(topology)
    loop = machine.loop
    n_units = topology.n_units
    for n in nodes:
        if n.unit >= n_units:
            raise ValueError(
                f"node {n.nid} ({n.name!r}) assigned to unit {n.unit} but "
                f"topology has {n_units} unit(s); re-partition the graph")

    remaining = {n.nid: len(n.deps) for n in nodes}
    dependents: "dict[int, list[Node]]" = {n.nid: [] for n in nodes}
    for n in nodes:
        for d in n.deps:
            dependents[d].append(n)
    span: "dict[int, tuple[float, float]]" = {}
    started: "dict[int, float]" = {}

    def complete(node: Node) -> None:
        span[node.nid] = (started[node.nid], loop.now)
        for succ in dependents[node.nid]:
            remaining[succ.nid] -= 1
            if remaining[succ.nid] == 0:
                ready(succ)

    def ready(node: Node) -> None:
        # Deps satisfied; the node still waits out its release time (a
        # request that has not arrived yet cannot enter the machine).
        if node.release_time > loop.now:
            loop.after(node.release_time - loop.now,
                       (lambda nn: lambda: start(nn))(node))
        else:
            start(node)

    def start(node: Node) -> None:
        started[node.nid] = loop.now
        mu = machine.units[node.unit]
        if node.kind == "matmul":
            _run_matmul(machine, mu, node, lambda: complete(node))
        elif node.kind == "vector":
            cyc = topology.vector.cycles_for(node.vector_ops)
            mu.vector.busy(cyc, node.name, then=lambda: complete(node))
        elif node.kind == "memory":
            work = node.mem_bytes / machine.memory_node_bpc
            machine.loader.transfer(work, node.name,
                                    then=lambda: complete(node))
        else:
            raise ValueError(f"unknown node kind {node.kind!r}")

    for n in nodes:                      # sources, in program order
        if remaining[n.nid] == 0:
            loop.after(max(0.0, n.release_time),
                       (lambda nn: lambda: start(nn))(n))

    loop.run()
    if len(span) != len(nodes):
        stuck = [n.nid for n in nodes if n.nid not in span]
        raise RuntimeError(f"graph deadlocked; unfinished nodes {stuck[:8]}")

    intervals = {"mem_loader": machine.loader.intervals}
    capacity = {"mem_loader": 1}
    for mu in machine.units:
        for r in mu.resources():
            intervals[r.name] = r.intervals
            capacity[r.name] = r.capacity
        if mu.private_loader is not None:
            intervals[mu.private_loader.name] = mu.private_loader.intervals
            capacity[mu.private_loader.name] = 1
    # Makespan from recorded activity, not the raw event-heap horizon:
    # the fair-share loader leaves superseded no-op wakeups in the heap.
    makespan = 0.0
    for s, e in span.values():
        makespan = max(makespan, e)
    for ivals in intervals.values():
        for _, e, _ in ivals:
            makespan = max(makespan, e)

    # Ideal cycles are per-node against the *owning* unit's throughput —
    # on a heterogeneous cluster a fast unit's tile has a smaller bound.
    unit = topology.unit
    ideal = sum(n.task.macs
                / topology.unit_config(n.unit).macs_per_cycle(
                    n.task.data_type)
                for n in nodes if n.kind == "matmul")
    return ClusterDESimResult(
        cycles=makespan, ideal_matrix_cycles=ideal, node_span=span,
        intervals=intervals, capacity=capacity, freq_hz=unit.freq_hz,
        n_units=n_units, loader_busy=machine.loader.busy_cycles(),
        topology=topology)


def simulate_graph(graph: TaskGraph, unit: MatrixUnitConfig,
                   platform: CpuPlatform = SHUTTLE,
                   vector_unit: VectorUnit = SATURN_512,
                   machine: Optional[Machine] = None) -> DESimResult:
    """Run ``graph`` to completion on the classic single-unit machine
    (``n_units=1``, dedicated FCFS loader, K-streamed fills — the same
    chunked scratchpad streaming every cluster machine uses); returns
    timelines + utilization."""
    if machine is not None:
        unit, platform = machine.unit, machine.platform
        vector_unit = machine.vector_unit
    topo = ClusterTopology(n_units=1, unit=unit, platform=platform,
                           vector=vector_unit, loader_policy="fcfs")
    return simulate_cluster(graph, topo)


def _run_matmul(machine: ClusterMachine, mu: UnitMachine, node: Node,
                done: Callable[[], None]) -> None:
    """dispatch → bank → load (k-chunked) → compute → (writeback ‖ poll)
    → done."""
    topo = machine.topology
    platform = topo.platform
    unit = mu.config                   # the owning unit's own geometry
    label = node.name
    # A private bandwidth slice keeps this unit's tile traffic off the
    # contended pool (cross-unit transfers still share — see `start`).
    if mu.private_loader is not None:
        loader, bpc = mu.private_loader, mu.private_bpc
        streams = 1                    # a private slice never interleaves
    else:
        loader, bpc = machine.loader, machine.loader_bpc
        streams = topo.interleaved_streams()
    w = tile_work(unit, platform, node, streams=streams)
    if topo.k_stream:
        chunks = tile_chunks(unit, platform, node, streams=streams)
    else:
        chunks = [(w["load_eff"], w["compute"])]
    n_chunks = len(chunks)

    bank_start = [0.0]
    loaded = [False] * n_chunks
    next_compute = [0]
    pe_free = [True]

    def after_dispatch():
        def granted():
            bank_start[0] = machine.loop.now
            issue_load(0)

        mu.banks.acquire(granted)

    def issue_load(j):
        loader.transfer(chunks[j][0] / bpc, label,
                        then=lambda: chunk_loaded(j))

    def chunk_loaded(j):
        loaded[j] = True
        if j + 1 < n_chunks:
            issue_load(j + 1)           # chunks of one tile stream serially
        maybe_compute()

    def maybe_compute():
        j = next_compute[0]
        if pe_free[0] and j < n_chunks and loaded[j]:
            pe_free[0] = False
            mu.pe.busy(chunks[j][1], label,
                       then=lambda: chunk_computed(j))

    def chunk_computed(j):
        pe_free[0] = True
        next_compute[0] += 1
        if next_compute[0] == n_chunks:
            finish()
        else:
            maybe_compute()

    def finish():
        # A/B bank held from load start to compute end, then freed.
        mu.banks.intervals.append((bank_start[0], machine.loop.now, label))
        mu.banks.release()
        loader.transfer(w["wb_eff"] / bpc, label + "/wb")
        # Result usable after the PE pipeline drains; the CPU then owes a
        # checkMatmul poll before dependents (vector epilogues) may issue.
        machine.loop.after(
            unit.pe_pipeline_stages,
            lambda: mu.dispatcher.busy(
                platform.check_cycles, label + "/chk", then=done))

    mu.dispatcher.busy(platform.dispatch_cycles, label + "/disp",
                       then=after_dispatch)
