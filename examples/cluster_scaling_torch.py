"""Cluster scaling: N matrix units sharing one memory loader.

    PYTHONPATH=src python examples/cluster_scaling_torch.py [--units 8]
        [--out cluster_trace.json] [--device cpu]

The PyTorch port's counterpart of ``cluster_scaling.py``: what happens
when N decoupled matrix units (paper §4) share memory bandwidth?  Three
experiments on the paper's GEMM regime (int8, 512 rows/unit × 512 ×
8192, the Fig. 6 setup), in simulated cycles of the paper's CPU matrix
unit:

1. **Weak scaling, pooled bandwidth** — every unit brings its own
   memory channel into the shared pool (``ClusterTopology`` default).
2. **Weak scaling, fixed bandwidth** — the pool stays at one unit's
   channel: the shared loader saturates and aggregate matrix
   utilization collapses ~1/N beyond the knee.
3. **Strategy comparison** — the same 4-unit GEMM under row-panel /
   output-tile / layer-pipeline partitioning, via the registered
   ``desim-cluster`` backend, plus the ``sharded`` backend executing
   the identical partitioned graph (one CUDA fused-matmul launch a
   unit's span) bit-exactly against ``kernel``.

The widest sweep entry's trace is exported as Chrome-trace JSON: open
it in https://ui.perfetto.dev — one process per unit, the shared
loader's overlapping transfers on pid 0 are the contention, visible.

Runs on the CUDA card; ``--device cpu`` runs the kernel's plain version
on the CPU instead, and without a card and without ``--device`` it stops
with an error.
"""

import argparse
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch import backend
from repro_torch.core.config import PLATFORM_2TOPS
from repro_torch.core.hardware import GIGA, SHUTTLE
from repro_torch.core.task import MatMulTask
from repro_torch.launch.serve import resolve_device
from repro_torch.sim import (ClusterTopology, build_gemm_graph,
                             dump_chrome_trace, partition_graph,
                             simulate_cluster)

STRATEGIES = ("row-panel", "output-tile", "layer-pipeline")
#: the strategy comparison's GEMM
STRATEGY_TASK = MatMulTask(m=512, n=512, k=2048)


def weak_gemm(n_units):
    """One paper-regime GEMM per unit (rows scale with the cluster)."""
    return MatMulTask(m=512 * n_units, n=512, k=8192)


def run(n_units, total_bandwidth=None, strategy="row-panel"):
    unit = PLATFORM_2TOPS
    g, _ = build_gemm_graph(weak_gemm(n_units), unit.m_scp, unit.n_scp)
    part = partition_graph(g, n_units, strategy)
    topo = ClusterTopology(n_units=n_units, unit=unit, platform=SHUTTLE,
                           total_bandwidth=total_bandwidth)
    return part, simulate_cluster(part.graph, topo)


def operands(device, task=STRATEGY_TASK, seed=0):
    """(A, B), int8 in [-8, 8), from a seeded generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randint(-8, 8, (task.m, task.k), generator=gen, device=device,
                      dtype=torch.int8)
    b = torch.randint(-8, 8, (task.k, task.n), generator=gen, device=device,
                      dtype=torch.int8)
    return a, b


def strategies(a, b, task=STRATEGY_TASK, units=4):
    """Each strategy priced on ``desim-cluster`` and executed by the
    ``sharded`` backend, beside the single-unit ``kernel`` result:
    (kernel output, {strategy: (priced ExecResult, sharded output)})."""
    kern = backend.get("kernel")
    ref = kern.wait(kern.dispatch(task, backend.MatMulOperands(a=a, b=b)))
    out = {}
    for strategy in STRATEGIES:
        eng = backend.get("desim-cluster", units=units, strategy=strategy)
        r = eng.wait(eng.dispatch(task))
        sh = backend.get("sharded", units=units, strategy=strategy)
        res = sh.wait(sh.dispatch(task, backend.MatMulOperands(a=a, b=b)))
        out[strategy] = (r, res.output)
    return ref.output, out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--units", type=int, default=8,
                    help="largest cluster in the sweep")
    ap.add_argument("--out", default="cluster_trace.json",
                    help="Chrome-trace output for the widest sweep run")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, required)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    sweep = [n for n in (1, 2, 4, 8, 16) if n <= max(args.units, 1)]

    # 1. weak scaling, pooled bandwidth -----------------------------------
    print("weak scaling, pooled loader bandwidth (n x 48 GB/s):")
    print(f"{'units':>6}{'cycles':>12}{'agg_util':>10}{'loader':>8}"
          f"{'contention':>12}{'xfers':>7}")
    base = None
    for n in sweep:
        part, r = run(n)
        base = base or r.cycles
        print(f"{n:>6}{r.cycles:>12.0f}"
              f"{r.aggregate_matrix_utilization:>10.3f}"
              f"{r.loader_utilization:>8.2f}"
              f"{r.loader_contention():>12.2f}{part.n_transfers:>7}")

    # 2. weak scaling, fixed pool: where the shared loader saturates ------
    bw = PLATFORM_2TOPS.bandwidth
    print(f"\nweak scaling, fixed {bw / GIGA:.0f} GB/s pool "
          "(the saturation curve):")
    print(f"{'units':>6}{'cycles':>12}{'agg_util':>10}{'loader':>8}"
          f"{'scaling_eff':>12}")
    for n in sweep:
        _, r = run(n, total_bandwidth=bw)
        print(f"{n:>6}{r.cycles:>12.0f}"
              f"{r.aggregate_matrix_utilization:>10.3f}"
              f"{r.loader_utilization:>8.2f}{base / r.cycles:>12.3f}")

    # 3. strategies through the registered backends -----------------------
    print("\n4-unit strategies (desim-cluster backend) + sharded parity:")
    a, b = operands(device)
    ref, by_strategy = strategies(a, b)
    exact = {}
    for strategy, (r, out) in by_strategy.items():
        exact[strategy] = bool(torch.equal(out, ref))
        print(f"  {strategy:<16} cycles={r.cycles:>9.0f} "
              f"agg_util={r.utilization:.3f} "
              f"xfers={r.detail['partition']['transfers']:>3} "
              f"sharded==kernel: {exact[strategy]}")

    # 4. trace export ------------------------------------------------------
    widest = max(sweep)
    _, rw = run(widest)
    path = dump_chrome_trace(rw, args.out,
                             process_name=f"cutev2-cluster x{widest}")
    print(f"\nwrote {widest}-unit trace to {path} - open in "
          "https://ui.perfetto.dev (one process per unit; the "
          "overlapping mem_loader events are the shared-bandwidth "
          "contention)")
    return {"sweep": sweep, "exact": exact, "strategies": by_strategy,
            "a": a, "b": b, "kernel": ref, "trace": path}


if __name__ == "__main__":
    main()
