"""Cycle-approximate simulator of the CUTEv2 matrix unit + vector unit.

The paper evaluates on Chipyard + Verilator + DRAMSim RTL simulation.  We
reproduce its *claims* with a first-order analytical model of the same
microarchitecture (§4.1):

* **Memory Loader** — streams A/B panels and writes back C at the SoC's
  data-supply bandwidth, derated by a DRAM-efficiency factor (the paper
  attributes its GEMM fluctuations to DRAMSim stride behaviour, §5.4).
* **Scratchpad** — multi-bank, so loading overlaps compute (double
  buffering); the fp32/int32 accumulator tile stays resident across the
  whole K sweep (output-stationary, §4.1) and is written back once.
* **PE array** — ``M_pe × N_pe`` PEs, each reducing ``K_pe`` bits/cycle;
  six-stage pipeline gives a fill latency.
* **CPU front-end** — per-tile ``asyncMatMul`` dispatch cost depends on
  the interface (RoCC few cycles, CSR mailbox ~100; paper §4.4/Table 3).
  Dispatch proceeds concurrently with the unit, so it only exposes when
  the CPU cannot stay ahead of the matrix unit.
* **Vector unit** — Saturn-style 512-bit RVV; element-wise ops modelled
  with instructions/element and a slow non-pipelined divider (the paper
  calls out SiLU/softmax division cost on Saturn explicitly, §5.4).

Fused (Listing 1) execution overlaps per-tile vector epilogues with
matrix compute and skips the DRAM round-trip of the intermediate;
unfused runs matrix then vector with the round-trip.  Commercial
baselines (Table 5) use a synchronous no-overlap model with calibrated
efficiency factors.

A copy of the reference's ``repro/core/simulator.py``.  Its cycles are
simulated cycles of the paper's CPU matrix unit, not GPU time.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core.config import MatrixUnitConfig
from repro_torch.core.hardware import CommercialBaseline, CpuPlatform, SHUTTLE
from repro_torch.core.precision import DataType, policy
from repro_torch.core.task import BiasType, MatMulTask


# ---------------------------------------------------------------------------
# Vector-unit model.
# ---------------------------------------------------------------------------

#: vector instructions per element (fp32 lanes), first-order costs.
VECTOR_OP_INSTRS = {
    "copy": 1, "add": 1, "mul": 1, "bias": 1, "residual": 1, "relu": 1,
    "relu2": 2, "quant": 3, "dequant": 2, "rope": 6, "exp": 8,
    "gelu": 12, "tanh": 9, "softcap": 11,
    "sigmoid": 9,     # exp + add (div accounted separately)
    "silu": 10,       # sigmoid + mul (div accounted separately)
    "softmax": 12,    # max-reduce + exp + sum-reduce (div separately)
    "rmsnorm": 8,     # square + reduce + rsqrt + scale
    "layernorm": 11,
    "swiglu": 12, "geglu": 14, "glu_mul": 1,
    "topk_route": 24, "scatter": 4, "gather": 4,
    "pool": 2, "eltwise_misc": 2,
}

#: ops whose inner divide hits the non-pipelined divider (elems per divide).
DIV_OPS = {"silu": 1.0, "sigmoid": 1.0, "softmax": 1.0, "layernorm": 0.0}


@dataclasses.dataclass(frozen=True)
class VectorUnit:
    bits: int = 512
    freq_hz: float = 2.0e9
    issue: int = 2       # Saturn on the 3-issue Shuttle dual-issues vector
    div_elems_per_cycle: float = 2.0   # Saturn: element-wise, not pipelined

    @property
    def lanes(self) -> int:
        return (self.bits // 32) * self.issue    # fp32 lanes

    def cycles(self, op: str, n_elems: float) -> float:
        instrs = VECTOR_OP_INSTRS[op]
        c = n_elems / self.lanes * instrs
        if op in DIV_OPS and DIV_OPS[op] > 0:
            c += n_elems * DIV_OPS[op] / self.div_elems_per_cycle
        return c

    def cycles_for(self, vector_ops: "dict[str, float]") -> float:
        return sum(self.cycles(op, n) for op, n in vector_ops.items())


SATURN_512 = VectorUnit()


# ---------------------------------------------------------------------------
# GEMM on the matrix unit.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SimResult:
    cycles: float
    ideal_cycles: float
    breakdown: dict

    @property
    def utilization(self) -> float:
        return self.ideal_cycles / self.cycles if self.cycles else 0.0

    def seconds(self, freq_hz: float) -> float:
        return self.cycles / freq_hz


def _tile_extents(total: int, tile: int):
    full, rem = divmod(total, tile)
    return [tile] * full + ([rem] if rem else [])


def simulate_gemm(unit: MatrixUnitConfig, task: MatMulTask,
                  platform: CpuPlatform = SHUTTLE,
                  out_bytes: float = 4.0) -> SimResult:
    """Output-stationary GEMM schedule; returns matrix-unit cycles."""
    dt = task.data_type
    eb = policy(dt).bytes_per_elem
    macs_cyc = unit.macs_per_cycle(dt)
    bw_cyc = unit.bandwidth * platform.dram_efficiency / unit.freq_hz

    compute_total = 0.0
    mem_total = 0.0
    busy_total = 0.0
    n_tiles = 0
    for m_t in _tile_extents(task.m, unit.m_scp):
        for n_t in _tile_extents(task.n, unit.n_scp):
            # PE-array quantisation: partial rows/cols still occupy PEs.
            m_eff = math.ceil(m_t / unit.m_pe) * unit.m_pe
            n_eff = math.ceil(n_t / unit.n_pe) * unit.n_pe
            k_eff = math.ceil(task.k / unit.k_pe_elems(dt)) * unit.k_pe_elems(dt)
            compute = m_eff * n_eff * k_eff / macs_cyc
            bias_bytes = {BiasType.ZERO: 0.0, BiasType.ROW: n_t * 4.0,
                          BiasType.FULL: m_t * n_t * 4.0}[task.bias_type]
            mem_bytes = ((m_t + n_t) * task.k * eb
                         + m_t * n_t * out_bytes + bias_bytes)
            mem = mem_bytes / bw_cyc
            compute_total += compute
            mem_total += mem
            busy_total += max(compute, mem)   # double-buffered overlap
            n_tiles += 1

    # Pipeline fill: first chunk's load + PE pipeline depth.
    first_chunk = ((unit.m_scp + unit.n_scp) * unit.k_scp_bytes) / bw_cyc
    fill = first_chunk + unit.pe_pipeline_stages
    # CPU dispatch stream runs concurrently; expose only if it lags.
    dispatch = n_tiles * (platform.dispatch_cycles + platform.check_cycles)
    total = max(busy_total, dispatch) + fill

    ideal = task.m * task.n * task.k / macs_cyc
    return SimResult(total, ideal, {
        "compute": compute_total, "memory": mem_total, "dispatch": dispatch,
        "fill": fill, "tiles": n_tiles,
        "bound": "compute" if compute_total >= mem_total else "memory",
    })


# ---------------------------------------------------------------------------
# Layers and fused / unfused execution.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerTrace:
    """One fused region: GEMM(s) + the vector work around them.

    ``vector_ops`` maps op name → element count per execution.
    ``intermediate_bytes`` is the tensor that an *unfused* schedule
    round-trips through DRAM between matrix and vector phases.
    """

    name: str
    gemms: "tuple[MatMulTask, ...]"
    vector_ops: "dict[str, float]" = dataclasses.field(default_factory=dict)
    intermediate_bytes: float = 0.0
    repeat: int = 1

    def flops(self) -> float:
        return self.repeat * sum(t.flops for t in self.gemms)


def simulate_layer(unit: MatrixUnitConfig, layer: LayerTrace, *,
                   platform: CpuPlatform = SHUTTLE,
                   vector: VectorUnit = SATURN_512,
                   fused: bool = True) -> "dict[str, float]":
    """Cycles for one layer execution (matrix + vector), fused or not."""
    matrix = sum(simulate_gemm(unit, g, platform).cycles for g in layer.gemms)
    vec = vector.cycles_for(layer.vector_ops)
    bw_cyc = unit.bandwidth * platform.dram_efficiency / unit.freq_hz

    if fused:
        # Listing 1: software pipeline at matrix-tile granularity.  Steady
        # state runs the slower of the two streams; the shorter stream
        # hides.  Fill = one vector-tile epilogue exposed at the end.
        n_tiles = max(1, sum(
            math.ceil(g.m / unit.m_scp) * math.ceil(g.n / unit.n_scp)
            for g in layer.gemms))
        fill = vec / n_tiles
        cycles = max(matrix, vec) + fill
    else:
        # Unfused intermediates round-trip DRAM only beyond the L2
        # working set (small ResNet feature maps stay cached).
        spill = max(0.0, layer.intermediate_bytes - platform.l2_bytes)
        roundtrip = 2.0 * spill / bw_cyc
        cycles = matrix + vec + roundtrip
    return {"cycles": cycles * layer.repeat, "matrix": matrix * layer.repeat,
            "vector": vec * layer.repeat}


def simulate_workload(unit: MatrixUnitConfig, layers: "list[LayerTrace]", *,
                      platform: CpuPlatform = SHUTTLE,
                      vector: VectorUnit = SATURN_512,
                      fused: bool = True) -> "dict[str, float]":
    tot = {"cycles": 0.0, "matrix": 0.0, "vector": 0.0}
    for layer in layers:
        r = simulate_layer(unit, layer, platform=platform, vector=vector,
                           fused=fused)
        for k in tot:
            tot[k] += r[k]
    tot["seconds"] = tot["cycles"] / unit.freq_hz
    tot["flops"] = sum(l.flops() for l in layers)
    return tot


# ---------------------------------------------------------------------------
# Commercial baselines (Table 5): synchronous, no matrix-vector overlap.
# ---------------------------------------------------------------------------

def baseline_layer_seconds(base: CommercialBaseline, layer: LayerTrace,
                           vector: VectorUnit = SATURN_512,
                           workload: str = None) -> float:
    gemm_s = 0.0
    for g in layer.gemms:
        peak = base.int8_peak * base.sync_overhead
        t_compute = g.flops / peak
        t_mem = (g.in_bytes + g.out_bytes()) / base.bandwidth
        gemm_s += max(t_compute, t_mem)
    vec_cycles = vector.cycles_for(layer.vector_ops) / base.vector_relative
    vec_s = vec_cycles / vector.freq_hz
    spill = max(0.0, layer.intermediate_bytes - 2 * 2**20)   # server L2
    roundtrip_s = 2.0 * spill / base.bandwidth
    return ((gemm_s + vec_s + roundtrip_s) * layer.repeat
            / base.coverage(workload))


def baseline_workload_seconds(base: CommercialBaseline,
                              layers: "list[LayerTrace]",
                              vector: VectorUnit = SATURN_512,
                              workload: str = None) -> float:
    return sum(baseline_layer_seconds(base, l, vector, workload)
               for l in layers)
