"""One MatMulTask, three backends: dispatch it, simulate it, execute it.

    PYTHONPATH=src python examples/sim_timeline_torch.py [--out trace.json]
        [--device cpu]

The PyTorch port's counterpart of ``sim_timeline.py``.  Builds a
Llama-style fused Gate/Up projection as one ``MatMulTask`` and drives it
through the unified ``repro_torch.backend`` contract:

1. ``backend.get("desim")`` — ``dispatch``/``wait`` (asyncMatMul /
   checkMatmul) on the discrete-event machine model for each of the four
   CPU platforms: per-resource utilization + overlap attribution, in
   simulated cycles of the paper's CPU matrix unit;
2. ``backend.get("kernel")`` — the *same* TaskGraph executed for real
   through AsyncMatmulEngine, one launch of the CUDA fused-matmul kernel
   per matrix tile, checked against the direct fused ``cute_matmul``;
3. ``backend.get("analytical")`` — the closed-form makespan, cross-
   checked against the DES-derived one;
4. exports the simulated timeline as Chrome-trace JSON — open it at
   https://ui.perfetto.dev (or chrome://tracing) to see the dispatcher,
   memory loader, scratchpad banks, PE array and vector unit lanes.

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
from repro_torch.core.fusion import Epilogue, cute_matmul
from repro_torch.core.hardware import PLATFORMS
from repro_torch.core.simulator import LayerTrace
from repro_torch.core.task import MatMulTask
from repro_torch.launch.serve import resolve_device
from repro_torch.sim import chrome_trace, dump_chrome_trace
from repro_torch.sim.lower import epilogue_vector_ops

#: the Gate/Up-like int8 product: small enough to eyeball, and the SiLU
#: divides make the vector stream long (paper §5.4), so overlap shows.
M, N, K = 256, 512, 1024
EPILOGUE = Epilogue(activation="silu", glu=True, out_dtype=torch.float32)


def simulate(task, ep):
    """asyncMatMul on the DES backend, one per integration platform
    (PANEL granularity: GLU epilogues need full-N regions):
    {platform: ExecResult}."""
    results = {}
    for name, platform in PLATFORMS.items():
        eng = backend.get("desim", platform=platform, granularity="panel")
        handle = eng.dispatch(task, epilogue=ep)      # asyncMatMul
        results[name] = eng.wait(handle)              # checkMatmul
    return results


def overlap(task, ep):
    """The same layer, fused vs unfused schedule: (fused, unfused) cost
    dicts of the DES backend's ``run_workload``."""
    desim = backend.get("desim", granularity="panel")
    layer = LayerTrace("gate_up", (task,),
                       vector_ops=epilogue_vector_ops(ep, task.m, task.n),
                       intermediate_bytes=4.0 * task.m * task.n)
    return (desim.run_workload([layer], fused=True),
            desim.run_workload([layer], fused=False))


def lower(task, ep):
    """The TaskGraph the DES prices, at PANEL granularity."""
    return backend.get("desim", granularity="panel").lower(task, epilogue=ep)


def operands(device, seed=0):
    """(A, B), int8 in [-8, 8), from a seeded generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randint(-8, 8, (M, K), generator=gen, device=device,
                      dtype=torch.int8)
    b = torch.randint(-8, 8, (K, N), generator=gen, device=device,
                      dtype=torch.int8)
    return a, b


def execute(graph, a, b, ep):
    """The graph run by the kernel backend (one K1 launch a matrix tile)
    and the direct fused ``cute_matmul`` of the same operands:
    (graph output, direct output)."""
    out = backend.get("kernel").run_graph(
        graph, backend.MatMulOperands(a=a, b=b)).output
    return out, cute_matmul(a, b, epilogue=ep)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="desim_trace.json",
                    help="Chrome-trace output path (view in Perfetto)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, required)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ep = EPILOGUE
    task = MatMulTask(m=M, n=N, k=K)              # int8, the paper default

    # 1. asyncMatMul on the DES backend, one per integration platform ----
    print(f"{'platform':<12}{'cycles':>10}{'pe':>7}{'vec':>7}"
          f"{'loader':>8}{'disp':>7}")
    results = simulate(task, ep)
    for name, r in results.items():
        u = r.detail["utilizations"]
        print(f"{name:<12}{r.cycles:>10.0f}{u['pe_array']:>7.1%}"
              f"{u['vector_unit']:>7.1%}{u['mem_loader']:>8.1%}"
              f"{u['dispatcher']:>7.1%}")

    # Overlap attribution: the same layer, fused vs unfused schedule.
    fused, unfused = overlap(task, ep)
    print(f"\nfused {fused['cycles']:.0f} vs unfused {unfused['cycles']:.0f} "
          f"cycles -> overlap speedup "
          f"{unfused['cycles'] / fused['cycles']:.2f}x")

    # 2. The same graph, executed for real by the kernel backend ----------
    graph = lower(task, ep)
    a, b = operands(device)
    out, ref = execute(graph, a, b, ep)
    print(f"kernel backend on the same graph: out {tuple(out.shape)}, "
          f"max |Δ| vs cute_matmul = "
          f"{float((out - ref).abs().max()):.2e}")

    # 3. Closed-form cross-check ------------------------------------------
    analytical = backend.get("analytical", granularity="panel")
    ra = analytical.run_graph(graph)
    rd = results["shuttle"]
    print(f"analytical backend: {ra.cycles:.0f} cycles "
          f"({ra.cycles / rd.cycles - 1.0:+.2%} vs desim)")

    # 4. Chrome-trace export ----------------------------------------------
    path = dump_chrome_trace(rd.timeline, args.out,
                             process_name="cutev2-desim shuttle gate_up")
    n_events = len(chrome_trace(rd.timeline)["traceEvents"])
    print(f"\nwrote {n_events} trace events to {path} "
          f"- open in https://ui.perfetto.dev")
    return {"results": results, "fused": fused, "unfused": unfused,
            "graph": graph, "a": a, "b": b, "out": out, "ref": ref,
            "analytical": ra, "trace": path}


if __name__ == "__main__":
    main()
