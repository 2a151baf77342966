"""Quickstart: the CUTEv2 programming model in five minutes.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The PyTorch port's counterpart of ``quickstart.py``.  Walks Listing 1 of
the paper end-to-end: interface registers → asyncMatMul dispatch →
checkMatmul → overlapped vector epilogue → the same computation through
the hand-written CUDA fused-matmul kernel → the constraint model that
sized its tiles, solved with the H100's constants.

Runs on the CUDA card; ``--device cpu`` runs the kernel's plain version
on the CPU instead, and without a card and without ``--device`` it stops
with an error.
"""

import argparse
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.core import (ACTIVATIONS, AsyncMatmulEngine, BiasType,
                              CASE_STUDY, DataType, Epilogue,
                              EpilogueOperands, MatMulTask, cute_matmul,
                              pipelined_fused_matmul)
from repro_torch.core import constraint
from repro_torch.core.hardware import SHUTTLE
from repro_torch.core.simulator import simulate_gemm
from repro_torch.launch.serve import resolve_device

EPILOGUE = Epilogue(bias_type=BiasType.ROW, activation="gelu")


def operands(device, seed=0):
    """(A, W, bias): bf16 (256, 512) and (512, 1024) standard normals
    from a seeded generator on ``device``, a zero fp32 bias."""
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn((256, 512), generator=gen, device=device,
                    dtype=torch.bfloat16)
    w = torch.randn((512, 1024), generator=gen, device=device,
                    dtype=torch.bfloat16)
    return a, w, torch.zeros((1024,), dtype=torch.float32, device=device)


def dispatch(a, w, bias, task):
    """asyncMatMul / checkMatmul (Listing 1): (done right after dispatch,
    the waited result)."""
    eng = AsyncMatmulEngine()
    handle = eng.dispatch(task, a, w, epilogue=EPILOGUE,
                          operands=EpilogueOperands(bias=bias))
    done = eng.check(handle)
    return done, eng.wait(handle)                       # checkMatmul


def pipelined(a, w):
    """Tile-granular overlap: the vector epilogue rides each tile."""
    return pipelined_fused_matmul(a.float(), w.float(), ACTIVATIONS["gelu"],
                                  tile_m=64)


def kernel_route(a, w, bias):
    """The same matmul through the fused CUDA kernel (K1)."""
    return cute_matmul(a, w, epilogue=EPILOGUE,
                       operands=EpilogueOperands(bias=bias),
                       backend="kernel")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, required)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    a, w, bias = operands(device)

    # 1. The interface registers (paper Table 1) ---------------------------
    task = MatMulTask(m=256, n=1024, k=512, data_type=DataType.BF16,
                      bias_type=BiasType.ROW)
    print(f"task: {task.m}x{task.n}x{task.k}, {task.flops / 1e6:.1f} MFLOP, "
          f"AI={task.arithmetic_intensity():.1f} flop/byte")

    # 2. asyncMatMul / checkMatmul (Listing 1) -----------------------------
    done, out = dispatch(a, w, bias, task)
    print("dispatched; done?", done)
    print("result:", tuple(out.shape), out.dtype)

    # 3. Tile-granular overlap: vector epilogue rides each tile -----------
    out2 = pipelined(a, w)
    print("pipelined max |Δ| vs fused:",
          float((out2 - out.float()).abs().max()))

    # 4. The same matmul through the fused CUDA kernel ---------------------
    out3 = kernel_route(a, w, bias)
    print("kernel max |Δ|:", float((out3.float() - out.float()).abs().max()))

    # 5. Eq. 2, both levels -------------------------------------------------
    print("\npaper case study:", CASE_STUDY.describe())
    r = simulate_gemm(CASE_STUDY, MatMulTask(m=512, n=512, k=4096), SHUTTLE)
    print(f"simulated GEMM utilization: {r.utilization:.1%} "
          f"({r.breakdown['bound']}-bound)")
    tc = constraint.solve_tiles(DataType.BF16)
    print(f"H100 tile from the same constraint model: "
          f"({tc.bm}, {tc.bn}, {tc.bk}), shared memory {tc.smem_bytes} B "
          f"({tc.smem_bytes >> 10} KiB), "
          f"ideal util {tc.ideal_utilization:.1%}")
    return {"a": a, "w": w, "bias": bias, "done": done, "out": out,
            "pipelined": out2, "kernel": out3, "simulated": r, "tile": tc}


if __name__ == "__main__":
    main()
