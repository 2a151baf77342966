"""The closed-form backend: ``core.simulator`` behind the same contract.

``dispatch``/``run_graph`` price a TaskGraph with a closed-form pipeline
model over the *same* per-tile costs the DES charges (``tile_costs``):
per layer group, the steady state runs the slower of the matrix-tile
stream ``max(compute, load+writeback)`` and the CPU dispatch stream,
with the first load exposed as fill and the last compute/writeback/
status-poll as drain; fused epilogues overlap as ``max(matrix, vector)``
with one epilogue share exposed (paper Listing 1).  Where the desim
backend *derives* the makespan from the event schedule, this backend
asserts it — the cross-backend parity suite pins the two within ~1%.

``units > 1`` (or an explicit — possibly heterogeneous —
``ClusterTopology``) switches to the **contention-aware cluster form**:
the graph is sharded by ``sim.partition`` exactly as ``desim-cluster``
would shard it, each unit's stream is priced with that unit's own
geometry and k-streamed fill, and the shared memory loader is priced as
a processor-sharing server: a unit's transfers are derated by the
M/G/1-PS slowdown ``1 / (1 - ρ_other)`` (capped at the number of
contending units), where ``ρ_other`` is the fraction of the group
makespan the *other* units' traffic occupies — solved by a short fixed
point, with the pool's aggregate capacity ``Σ shared work`` as the
saturation bound.  Validated ≤5% against ``desim-cluster`` on the paper
GEMM regime, so ``ServingEngine.plan`` can price (policy × partition ×
topology) candidates without running the DES.

``run_workload`` is ``simulate_workload`` verbatim for a single unit
(the paper's model-level analytical numbers) and the per-layer cluster
form for ``units > 1``.  No array outputs are produced — this backend
answers "how long", not "what".
"""

from __future__ import annotations

from typing import Callable

from repro_torch.backend.base import (ExecResult, GraphOperands,
                                      MatMulOperands)
from repro_torch.backend.cluster_backend import PartitionedBackend
from repro_torch.backend.registry import register
from repro_torch.core.fusion import Epilogue, NO_EPILOGUE
from repro_torch.core.task import MatMulTask
from repro_torch.obs import instrument
from repro_torch.sim.lower import step_label

#: fixed-point sweeps for the shared-loader slowdown (converges in 2-3).
_CONTENTION_ITERS = 6


@register("analytical")
class AnalyticalBackend(PartitionedBackend):
    """First-order cost estimates from the closed-form model."""

    models_time = True

    def __init__(self, units: int = 1, strategy: str = "row-panel",
                 k_stream: bool = True, **kw):
        """``k_stream`` defaults on for every form — the single-unit
        closed form folds the first-chunk fill term exactly like the
        cluster form, matching the K-streamed machine ``simulate_graph``
        runs (parity re-baselined in ``tests/test_backend.py``, now
        within float noise on the GEMM regime).  ``k_stream=False``
        restores the legacy whole-tile-fill pricing for graphs simulated
        on a ``ClusterTopology(k_stream=False)`` machine."""
        super().__init__(units=units, strategy=strategy,
                         k_stream=k_stream, **kw)

    @property
    def _cluster(self) -> bool:
        return self.units > 1 or self._topology is not None

    def _stage(self, task: MatMulTask, operands: MatMulOperands,
               epilogue: Epilogue) -> Callable[[], ExecResult]:
        ep = None if epilogue is NO_EPILOGUE else epilogue
        graph = self.lower(task, epilogue=ep)
        if self._cluster:
            graph = self.partition(graph)
        return lambda: self.run_graph(graph)

    @instrument("run_graph")
    def run_graph(self, graph, operands: GraphOperands = None) -> ExecResult:
        """Closed-form makespan of a TaskGraph, mirroring the DES pipeline.

        Nodes are grouped by layer (successive layers of a schedule graph
        serialise on the dependency chain); within a group the matrix
        stream is ``fill + Σ max(compute, load+writeback) + drain``
        raced against the serial dispatch/check stream, and fused vector
        work overlaps it as ``max(matrix, vector)`` plus one exposed
        epilogue share.  Unfused groups (an explicit memory round-trip)
        serialise matrix, memory and vector phases.  With ``units > 1``
        the same walk runs per (group, unit) on the partitioned graph
        with the contention-aware shared-loader derate.
        """
        if self._cluster:
            return self._run_graph_cluster(graph)
        from repro_torch.sim.desim import (build_machine, tile_chunks,
                                           tile_costs)
        machine = build_machine(self.unit, self.platform, self.vector)
        raw_bpc = self.unit.bandwidth / self.unit.freq_hz
        plat = self.platform
        groups: "dict[str, dict]" = {}
        order: "list[str]" = []
        ideal = 0.0
        for node in graph.topo_order():
            key = step_label(node.layer)
            if key not in groups:
                groups[key] = {"tiles": [], "nodes": [], "vec": 0.0,
                               "n_vec": 0, "mem": 0.0, "release": 0.0}
                order.append(key)
            g = groups[key]
            g["release"] = max(g["release"], node.release_time)
            if node.kind == "matmul":
                g["tiles"].append(tile_costs(machine, node))
                g["nodes"].append(node)
                ideal += (node.task.macs
                          / self.unit.macs_per_cycle(node.task.data_type))
            elif node.kind == "vector":
                g["vec"] += self.vector.cycles_for(node.vector_ops)
                g["n_vec"] += 1
            elif node.kind == "memory":
                g["mem"] += node.mem_bytes / machine.bytes_per_cycle

        cycles = 0.0
        spans: "dict[str, tuple[float, float]]" = {}
        detail = {"matrix": 0.0, "vector": 0.0, "memory": 0.0,
                  "dispatch": 0.0, "groups": len(order)}
        for key in order:
            g = groups[key]
            tiles, vec, mem = g["tiles"], g["vec"], g["mem"]
            # Successive groups serialise on the chain; a group also
            # waits out its release time (request arrival semantics).
            start = max(cycles, g["release"])
            if not tiles:
                cycles = start + vec + mem
                spans[key] = (start, cycles)
                detail["vector"] += vec
                detail["memory"] += mem
                continue
            # Three streams race; the slower one carries the makespan.
            # PE stream: first load exposed as fill, then back-to-back
            # computes, then the last tile's writeback / pipeline drain.
            # With k_stream the fill shrinks to the first K chunk (the
            # rest of the first tile's load hides behind its compute) and
            # the compute exposed past the loader drain shrinks to the
            # last tile's final chunk.
            last = tiles[-1]
            fill_load = tiles[0]["load"]
            last_exposed = last["compute"]
            if self.k_stream:
                first_chunks = tile_chunks(self.unit, plat, g["nodes"][0])
                fill_load = first_chunks[0][0] / raw_bpc
                last_exposed = tile_chunks(self.unit, plat,
                                           g["nodes"][-1])[-1][1]
            pe_stream = (fill_load
                         + sum(c["compute"] for c in tiles)
                         + max(last["writeback"],
                               self.unit.pe_pipeline_stages
                               + plat.check_cycles))
            # Loader stream: every load and writeback serialises through
            # the memory loader; the last compute lands after the loads
            # drain, overlapping the ~two writebacks still backlogged.
            backlog = min(len(tiles) - 1, 2) * last["writeback"]
            loader_stream = (sum(c["load"] + c["writeback"] for c in tiles)
                             + max(0.0, last_exposed - backlog))
            dispatch = len(tiles) * (plat.dispatch_cycles
                                     + plat.check_cycles)
            matrix = plat.dispatch_cycles + max(pe_stream, loader_stream,
                                                dispatch)
            if g["n_vec"] > 1 and not mem:
                # fused: the slower stream carries the group.  A compute-
                # bound group exposes the last epilogue share after the
                # final tile; a loader-bound group keeps draining queued
                # writebacks meanwhile, hiding up to that backlog; a
                # vector-bound group exposes the first tile as fill.
                share = vec / g["n_vec"]
                if loader_stream > max(pe_stream, dispatch):
                    share = max(0.0, share - 3.0 * last["writeback"])
                fill = (plat.dispatch_cycles + tiles[0]["load"]
                        + tiles[0]["compute"])
                cycles = start + max(matrix + share, fill + vec)
            else:
                # one epilogue after everything (LAYER granularity or an
                # unfused round-trip): phases serialise.
                cycles = start + matrix + vec + mem
            spans[key] = (start, cycles)
            detail["matrix"] += matrix
            detail["vector"] += vec
            detail["memory"] += mem
            detail["dispatch"] += dispatch
        detail["step_spans"] = spans
        return ExecResult(cycles=cycles, seconds=cycles / self.unit.freq_hz,
                          utilization=ideal / cycles if cycles else 0.0,
                          detail=detail)

    # ----- contention-aware cluster closed form ----------------------------
    def _run_graph_cluster(self, graph, topology=None) -> ExecResult:
        from repro_torch.sim.desim import tile_chunks, tile_work
        part = self.partition(graph)
        topo = topology if topology is not None else self.topology()
        plat = topo.platform
        freq = topo.unit.freq_hz
        pool_bpc = topo.shared_bandwidth / freq
        mem_bpc = pool_bpc * plat.dram_efficiency

        # Group by layer, then by owning unit within a group (units run
        # a group's shards concurrently).  Groups are scheduled as a DAG
        # — a chained schedule graph degenerates to the serial walk, a
        # relaxed one lets hazard-free groups overlap wherever their
        # units differ (per-unit availability keeps same-unit groups
        # serial, mirroring what the DES's resource contention does).
        groups: "dict[str, dict]" = {}
        order: "list[str]" = []
        key_of_nid: "dict[int, str]" = {}
        ideal = 0.0
        for node in part.graph.topo_order():
            key = step_label(node.layer)
            key_of_nid[node.nid] = key
            if key not in groups:
                groups[key] = {"units": {}, "mem": 0.0, "release": 0.0,
                               "deps": set()}
                order.append(key)
            g = groups[key]
            g["release"] = max(g["release"], node.release_time)
            for d in node.deps:
                dk = key_of_nid[d]
                if dk != key:
                    g["deps"].add(dk)
            u = node.unit
            if node.kind == "memory":
                # inter-unit transfers / spills ride the shared pool.
                g["mem"] += node.mem_bytes / mem_bpc
                continue
            st = g["units"].setdefault(
                u, {"tiles": [], "vec": 0.0, "n_vec": 0})
            if node.kind == "matmul":
                cfg = topo.unit_config(u)
                private = topo.private_bandwidth(u)
                bpc = private / freq if private > 0 else pool_bpc
                # same row-buffer interleaving derate the DES charges
                # shared-pool streams (private slices never interleave).
                streams = 1 if private > 0 else topo.interleaved_streams()
                w = tile_work(cfg, plat, node, streams=streams)
                fill_bytes = (tile_chunks(cfg, plat, node,
                                          streams=streams)[0][0]
                              if topo.k_stream else w["load_eff"])
                st["tiles"].append({
                    "compute": w["compute"],
                    "load": w["load_eff"] / bpc,
                    "writeback": w["wb_eff"] / bpc,
                    "fill": fill_bytes / bpc,
                    "shared": private <= 0,
                    "cfg": cfg,
                })
                ideal += (node.task.macs
                          / cfg.macs_per_cycle(node.task.data_type))
            else:
                st["vec"] += topo.vector.cycles_for(node.vector_ops)
                st["n_vec"] += 1

        detail = {"groups": len(order), "memory": 0.0}

        def place(bg: "dict[str, tuple[float, int]]"):
            """One DAG placement pass; ``bg`` carries each group's
            concurrent *background* loader traffic (cycles of other
            groups' shared work inside its window, and how many foreign
            units contend) into the PS fixed point."""
            cycles = 0.0
            shared_total = 0.0
            mem_total = 0.0
            unit_free = [0.0] * topo.n_units
            end: "dict[str, float]" = {}
            spans: "dict[str, tuple[float, float]]" = {}
            group_shared: "dict[str, float]" = {}
            for key in order:
                g = groups[key]
                extra, n_bg = bg.get(key, (0.0, 0))
                shared, unit_times = self._cluster_group_cycles(
                    g, plat, background=extra, bg_units=n_bg)
                group_shared[key] = shared
                base = max([g["release"]] + [end[d] for d in g["deps"]],
                           default=0.0)
                g_end = base
                for u, tu in unit_times.items():
                    s_u = max(base, unit_free[u])
                    unit_free[u] = s_u + tu
                    g_end = max(g_end, unit_free[u])
                # pool-capacity floor + serialised transfer traffic.
                g_end = max(g_end, base + shared) + g["mem"]
                end[key] = g_end
                spans[key] = (base, g_end)
                cycles = max(cycles, g_end)
                shared_total += shared + g["mem"]
                mem_total += g["mem"]
            return cycles, shared_total, mem_total, spans, group_shared

        def cross_group_bg(spans, group_shared):
            """Overlap-weighted background traffic per group from the
            previous pass's windows: group *h*'s shared work lands in
            group *g* proportionally to their window overlap.  Empty for
            any chained schedule (dep-serialised windows never overlap),
            which keeps those placements bit-identical to the
            single-pass form."""
            bg: "dict[str, tuple[float, int]]" = {}
            for key in order:
                s0, e0 = spans[key]
                extra, foreign = 0.0, set()
                for other in order:
                    if other == key or group_shared[other] <= 0.0:
                        continue
                    s1, e1 = spans[other]
                    ov = min(e0, e1) - max(s0, s1)
                    if ov <= 0.0 or e1 <= s1:
                        continue
                    extra += group_shared[other] * ov / (e1 - s1)
                    foreign.update(
                        u for u, st in groups[other]["units"].items()
                        if any(t["shared"] for t in st["tiles"]))
                if extra > 0.0:
                    bg[key] = (extra, len(foreign))
            return bg

        # Pass 1 prices every group's fixed point in isolation; when the
        # relaxed DAG actually overlapped groups, re-derate each group
        # with the concurrent groups' loader traffic and re-place (the
        # windows stretch, so one refinement pass re-measures overlap).
        bg: "dict[str, tuple[float, int]]" = {}
        cycles, shared_total, mem_total, spans, group_shared = place(bg)
        for _ in range(2):
            new_bg = cross_group_bg(spans, group_shared)
            if not new_bg or new_bg == bg:
                break
            bg = new_bg
            cycles, shared_total, mem_total, spans, group_shared = \
                place(bg)
        detail["memory"] = mem_total
        detail["rederated_groups"] = len(bg)
        detail["loader_utilization"] = (shared_total / cycles
                                        if cycles else 0.0)
        detail["step_spans"] = spans
        detail["partition"] = {"strategy": part.strategy,
                               "n_units": part.n_units,
                               "transfers": part.n_transfers,
                               "transfer_bytes": part.transfer_bytes}
        n = topo.n_units
        return ExecResult(
            cycles=cycles, seconds=cycles / freq,
            utilization=ideal / (cycles * n) if cycles else 0.0,
            detail=detail)

    def _cluster_group_cycles(self, g: dict, plat, background: float = 0.0,
                              bg_units: int = 0) -> "tuple[float, dict]":
        """One layer group on the cluster: per-unit streams raced
        concurrently, shared-loader traffic derated by the PS slowdown
        fixed point (the caller applies the pool-capacity floor when
        placing the group).  ``background`` is loader traffic from
        *other* groups concurrently in flight (cycles of shared work
        falling inside this group's window, spread over ``bg_units``
        foreign units) — it joins every unit's ``ρ_other`` and raises
        the contender cap, so an overlapped relaxed group sees the
        whole pool's load the way the DES makes it.  Returns ``(shared
        loader work, per-unit cycles at the converged slowdowns)``."""
        units = g["units"]
        if not units:
            return 0.0, {}
        shared_work = {
            u: sum(t["load"] + t["writeback"] for t in st["tiles"]
                   if t["shared"])
            for u, st in units.items()}
        total_shared = sum(shared_work.values())
        contenders = [u for u, w in shared_work.items() if w > 0]
        if background > 0.0 and not contenders:
            background = 0.0          # no shared traffic to derate

        def unit_time(u: int, s: float) -> float:
            st = units[u]
            tiles, vec = st["tiles"], st["vec"]
            if not tiles:
                return vec

            def derate(t):                 # slowdown on shared traffic only
                return s if t["shared"] else 1.0

            last = tiles[-1]
            cfg = last["cfg"]
            pe_stream = (tiles[0]["fill"] * derate(tiles[0])
                         + sum(t["compute"] for t in tiles)
                         + max(last["writeback"] * derate(last),
                               cfg.pe_pipeline_stages + plat.check_cycles))
            backlog = (min(len(tiles) - 1, 2)
                       * last["writeback"] * derate(last))
            loader_stream = (sum((t["load"] + t["writeback"]) * derate(t)
                                 for t in tiles)
                             + max(0.0, last["compute"] - backlog))
            dispatch = len(tiles) * (plat.dispatch_cycles
                                     + plat.check_cycles)
            matrix = plat.dispatch_cycles + max(pe_stream, loader_stream,
                                                dispatch)
            if st["n_vec"] > 1:
                share = vec / st["n_vec"]
                if loader_stream > max(pe_stream, dispatch):
                    share = max(0.0, share
                                - 3.0 * last["writeback"] * derate(last))
                fill = (plat.dispatch_cycles
                        + tiles[0]["load"] * derate(tiles[0])
                        + tiles[0]["compute"])
                return max(matrix + share, fill + vec)
            return matrix + vec

        slow = {u: 1.0 for u in units}
        t_group = 0.0
        for _ in range(_CONTENTION_ITERS):
            t_group = max(unit_time(u, slow[u]) for u in units)
            # pool capacity floor (own + concurrent background traffic).
            t_group = max(t_group, total_shared + background)
            cap = float(max(len(contenders) + bg_units, 1))
            for u in contenders:
                rho_other = (total_shared - shared_work[u]
                             + background) / t_group
                slow[u] = (min(cap, 1.0 / (1.0 - rho_other))
                           if rho_other < 1.0 else cap)
        unit_times = {u: unit_time(u, slow[u]) for u in units}
        return total_shared, unit_times

    @instrument("run_workload")
    def run_workload(self, layers, *, fused=None, unit=None, platform=None,
                     vector=None):
        fused = self.fused if fused is None else fused
        if self._cluster:
            return self._run_workload_cluster(
                layers, fused=fused,
                topology=self.topology(unit, platform, vector))
        from repro_torch.core.simulator import simulate_workload
        return simulate_workload(
            unit or self.unit, layers,
            platform=platform or self.platform,
            vector=vector or self.vector, fused=fused)

    def _run_workload_cluster(self, layers, *, fused: bool, topology):
        """``sim.lower.cluster_workload``'s dict shape, priced by the
        closed form instead of the DES: per layer, partition the graph
        across the topology's units and apply the contended formula."""
        from repro_torch.sim.lower import aggregate_cluster_workload, \
            layer_to_graph

        def price_layer(layer):
            graph, _ = layer_to_graph(topology.unit, layer, fused=fused,
                                      granularity=self.granularity,
                                      platform=topology.platform)
            part = self.partition(graph)
            r = self._run_graph_cluster(part, topology)
            ideal = r.utilization * r.cycles * topology.n_units
            return {
                "cycles": r.cycles,
                "matrix": ideal,       # first order: busy PE == ideal
                "vector": sum(topology.vector.cycles_for(n.vector_ops)
                              for n in part.graph.vector_nodes()),
                "ideal": ideal,
                "loader_busy": r.detail["loader_utilization"] * r.cycles,
                "transfers": part.n_transfers,
            }

        return aggregate_cluster_workload(topology, layers, price_layer)
