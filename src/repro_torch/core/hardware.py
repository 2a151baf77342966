"""Hardware descriptions for both sides of the CUTEv2 adaptation.

Two families live here:

* ``CpuPlatform`` — the four open-source RISC-V CPUs the paper integrates
  into (Rocket / Shuttle / BOOM / XiangShan-Kunminghu), plus the three
  commercial baselines of Table 5 (Xeon 8580 AMX, IBM S1022 MMA, Apple M4
  SME).  These feed the cycle-approximate simulator that reproduces the
  paper's figures.

* ``GpuChip`` — the NVIDIA H100 target of the PyTorch/CUDA port.  Kernel
  roofline bounds read their constants from here.

All bandwidths are bytes/second, frequencies in Hz, throughputs in ops/s
(1 MAC = 2 ops, matching the paper's Eq. 1).
"""

from __future__ import annotations

import dataclasses

GIGA = 1e9
TERA = 1e12
MEBI = 2**20
GIBI = 2**30


@dataclasses.dataclass(frozen=True)
class CpuPlatform:
    """A CPU front-end + memory system hosting the matrix extension.

    ``dispatch_cycles`` models the cost of programming the interface
    registers (paper Table 1) and firing one ``asyncMatMul``: a handful of
    cycles over RoCC, noticeably more over the CSR path used for
    XiangShan (paper §4.4).  ``dram_efficiency`` derates the nominal
    DRAMSim bandwidth for strided access patterns (paper §5.4 notes the
    GEMM fluctuations come from exactly this).
    """

    name: str
    microarch: str
    interface: str            # "RoCC" | "CSR"
    freq_hz: float
    dispatch_cycles: int      # per asyncMatMul task
    check_cycles: int         # per checkMatmul poll
    dram_efficiency: float    # achieved / nominal bandwidth
    l2_bytes: float = 1 * MEBI  # unfused intermediates below this stay on-chip

    # Vector unit attached to this CPU (the paper pairs Saturn 512-bit RVV).
    vector_bits: int = 512
    vector_issue: int = 1     # vector ops issued per cycle


# ---------------------------------------------------------------------------
# The four integration platforms (paper Table 3 / §5.2).
# Dispatch costs: RoCC is a tightly-coupled custom-instruction port (a few
# cycles); the CSR mailbox on Kunminghu costs a CSR write per field.
# ---------------------------------------------------------------------------
ROCKET = CpuPlatform("rocket", "in-order 1-issue", "RoCC", 2.0 * GIGA,
                     dispatch_cycles=24, check_cycles=6, dram_efficiency=0.92)
SHUTTLE = CpuPlatform("shuttle", "in-order 3-issue", "RoCC", 2.0 * GIGA,
                      dispatch_cycles=16, check_cycles=4, dram_efficiency=0.92)
BOOM = CpuPlatform("boom", "OoO 4-issue", "RoCC", 2.0 * GIGA,
                   dispatch_cycles=12, check_cycles=3, dram_efficiency=0.92)
KUNMINGHU = CpuPlatform("kunminghu", "OoO 6-issue", "CSR", 2.0 * GIGA,
                        dispatch_cycles=96, check_cycles=12, dram_efficiency=0.92)

PLATFORMS = {p.name: p for p in (ROCKET, SHUTTLE, BOOM, KUNMINGHU)}


@dataclasses.dataclass(frozen=True)
class CommercialBaseline:
    """Paper Table 5: commercial matrix extensions we compare against.

    ``sync_overhead`` models the fine-grained synchronous-instruction
    execution model (no matrix/vector overlap, per-tile issue pressure in
    the CPU instruction window) as a multiplicative derate on achievable
    matrix throughput on large GEMM (Fig. 8 regime).

    ``op_coverage`` is the per-workload *framework efficiency* the paper
    measures (§5.4 commentary): SME/ORT has **no convolution support**
    (ResNet falls back to scalar/NEON paths), MMA/ORT operator coverage
    is far behind OpenVINO on ResNet, OpenVINO pays softmax/SiLU costs on
    Llama3, etc.  These nine scalars are calibrated once against the
    paper's *unfused* column of Table 6 and then held fixed — the
    fused/unfused ratios and the overlap-contribution split remain
    genuine model predictions (benchmarks/run.py reports both raw and
    coverage-calibrated numbers).
    """

    name: str
    ise: str
    framework: str
    bandwidth: float          # bytes/s per core (MLC / STREAM measured)
    int8_peak: float          # ops/s per core
    sync_overhead: float      # fraction of peak reachable on large GEMM
    vector_relative: float    # vector-unit throughput relative to Saturn-512
    op_coverage: tuple = ()   # ((workload, efficiency), ...)

    def coverage(self, workload: "str | None") -> float:
        return dict(self.op_coverage).get(workload, 1.0)


XEON_8580 = CommercialBaseline(
    "xeon8580", "AMX", "OpenVINO", 49.48 * GIGA, 4.6 * TERA,
    sync_overhead=0.72, vector_relative=2.0,
    # Best operator support of the three (§5.4); Llama3 pays SmoothQuant
    # (de)quant + softmax overheads OpenVINO does not fuse.
    op_coverage=(("resnet50", 0.60), ("bert", 0.55), ("llama3", 0.45)))
IBM_S1022 = CommercialBaseline(
    "ibms1022", "MMA", "ONNXRuntime", 52.37 * GIGA, 2.0 * TERA,
    sync_overhead=0.35, vector_relative=1.0,
    # ORT+OpenBLAS coverage is weak on conv (Fig. 9 commentary).
    op_coverage=(("resnet50", 0.28), ("bert", 0.80), ("llama3", 1.0)))
APPLE_M4 = CommercialBaseline(
    "applem4", "SME", "ONNXRuntime", 131.31 * GIGA, 4.0 * TERA,
    sync_overhead=0.80, vector_relative=1.5,
    # "Currently, SME lacks support for convolution operators" (§5.4).
    op_coverage=(("resnet50", 0.16), ("bert", 0.40), ("llama3", 0.30)))

BASELINES = {b.name: b for b in (XEON_8580, IBM_S1022, APPLE_M4)}


# ---------------------------------------------------------------------------
# GPU target (the hardware-adaptation side of the port).
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class GpuChip:
    """Published per-card peaks, read by roofline bounds."""

    name: str
    peak_bf16: float          # FLOP/s, dense tensor cores (also fp16)
    peak_fp8: float           # FLOP/s
    peak_int8: float          # OP/s
    peak_tf32: float          # FLOP/s
    peak_fp32: float          # FLOP/s outside the tensor cores
    hbm_bw: float             # bytes/s
    hbm_bytes: float          # capacity
    smem_per_block: int       # largest dynamic shared memory a block can use
    sms: int
    nvlink_bw: float          # bytes/s, aggregate of all links, both ways
    l2_bytes: float           # capacity


# NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit.
H100_SXM = GpuChip(
    name="h100_sxm",
    peak_bf16=989 * TERA,
    peak_fp8=1979 * TERA,
    peak_int8=1979 * TERA,
    peak_tf32=495 * TERA,
    peak_fp32=67 * TERA,
    hbm_bw=3.35 * TERA,
    hbm_bytes=80 * GIGA,
    smem_per_block=232448,
    sms=132,
    # 18 NVLink 4 links, 900 GB/s summed over links and both directions
    # (450 GB/s each way).  The roofline divides a card's collective bytes
    # by this aggregate undivided, as the reference divides by its chip's
    # ``ici_bw_total`` (every link's rate summed).
    nvlink_bw=900 * GIGA,
    l2_bytes=50 * MEBI,
)

TARGET_CHIP = H100_SXM
