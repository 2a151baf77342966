"""The compute–bandwidth constraint model (paper Eq. 2) — both levels.

Level 1 (the paper's): size the scratchpad so that, under output-
stationary scheduling, the memory loader can keep the PE array busy.
Per unit of K, a resident ``(M_scp, N_scp)`` output tile costs

    compute cycles = M_scp · N_scp / (M_pe · N_pe · K_pe_elems)
    memory  cycles = (M_scp + N_scp) · elem_bytes / bytes_per_cycle

The utilization-guaranteeing direction is ``memory ≤ compute`` (PE never
starves), which yields a *minimum* scratchpad tile.  The paper's Eq. 2 is
printed with the opposite inequality ("compute ≤ memory"); as written it
would bound the scratchpad from *above* and would contradict Fig. 7
(lower bandwidth ⇒ larger scratchpad).  We implement the physical
direction and keep ``paper_eq2_lhs_rhs`` so the reproduction tests can
exercise the printed form too.  Level 1 is the reference's
(``repro.core.constraint``), line for line.

Level 2 (the Hopper adaptation), re-derived from the reference's TPU
form; the reference's names are kept:
  * HBM→SMEM: choose the tensor-core GEMM tile ``(bm, bn, bk)`` so that
    an SM's tensor-core time on one K step of the tile covers the time
    its share of HBM bandwidth takes to bring the step's A and B panels,
    under the shared-memory capacity of one block.
  * NVLink: choose how much of a weight matrix to keep card-resident vs.
    re-gather, comparing matmul time against link time.

Level 2a sees HBM only.  A square bf16 tile that covers its own loads
from HBM alone needs t/2 FLOP/B ≥ 989/3.35 ≈ 295, t ≈ 590, which no
block's shared memory holds.  K1's tile (``kernels/matmul/matmul.py``:
128×128×64, 4 stages) nonetheless runs well above this model's
utilisation at the prefill GLU shape on an H100 (``PERF.md`` §6),
because blocks that share an A or B panel find it in the 50 MB L2.  The
model has no term for that reuse.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.config import MatrixUnitConfig
from repro_torch.core.hardware import GpuChip, TARGET_CHIP
from repro_torch.core.precision import DataType, policy
from repro_torch.kernels.matmul.matmul import TC_BK, TC_STAGES


# ---------------------------------------------------------------------------
# Level 1: the paper's scratchpad constraint.
# ---------------------------------------------------------------------------

def compute_cycles_per_k(cfg: MatrixUnitConfig, dt: DataType,
                         m_scp: int = None, n_scp: int = None) -> float:
    m = cfg.m_scp if m_scp is None else m_scp
    n = cfg.n_scp if n_scp is None else n_scp
    return m * n / (cfg.m_pe * cfg.n_pe * cfg.k_pe_elems(dt))


def memory_cycles_per_k(cfg: MatrixUnitConfig, dt: DataType,
                        m_scp: int = None, n_scp: int = None) -> float:
    m = cfg.m_scp if m_scp is None else m_scp
    n = cfg.n_scp if n_scp is None else n_scp
    return (m + n) * policy(dt).bytes_per_elem / cfg.bytes_per_cycle()


def feeds_pe_array(cfg: MatrixUnitConfig, dt: DataType = DataType.INT8) -> bool:
    """True iff the memory system can keep the PE array saturated."""
    return memory_cycles_per_k(cfg, dt) <= compute_cycles_per_k(cfg, dt)


def ideal_utilization(cfg: MatrixUnitConfig, dt: DataType = DataType.INT8) -> float:
    """Steady-state PE utilization bound implied by the constraint model."""
    c = compute_cycles_per_k(cfg, dt)
    m = memory_cycles_per_k(cfg, dt)
    return min(1.0, c / m) if m > c else 1.0


def paper_eq2_lhs_rhs(cfg: MatrixUnitConfig, dt: DataType = DataType.INT8):
    """Eq. 2 exactly as printed: (M·N·K)/(F·Mpe·Npe·Kpe) vs ((M+N)·K)/BW.

    Returned in seconds, K = K_scp.  (K cancels in the comparison; we keep
    it for fidelity to the printed form.)
    """
    k = cfg.k_scp_bytes / policy(dt).bytes_per_elem
    lhs = (cfg.m_scp * cfg.n_scp * k) / (
        cfg.freq_hz * cfg.m_pe * cfg.n_pe * cfg.k_pe_elems(dt))
    rhs = ((cfg.m_scp + cfg.n_scp) * k * policy(dt).bytes_per_elem) / cfg.bandwidth
    return lhs, rhs


def solve_scratchpad(cfg: MatrixUnitConfig, dt: DataType = DataType.INT8,
                     max_tile: int = 1024) -> "tuple[int, int]":
    """Smallest square power-of-two (M_scp, N_scp) that saturates the PEs.

    Square tiles minimise (M+N) loads per output element, matching the
    paper's symmetric choices (64×64 for the case study).
    """
    t = 16
    while t <= max_tile:
        if (memory_cycles_per_k(cfg, dt, t, t)
                <= compute_cycles_per_k(cfg, dt, t, t)):
            return t, t
        t *= 2
    return max_tile, max_tile


# ---------------------------------------------------------------------------
# Level 2a: Hopper tile solver (HBM → shared memory).
# ---------------------------------------------------------------------------

#: wgmma's units: a warpgroup owns 64 rows of M; N is a multiple of 8 up
#: to 256 in one instruction.
WGMMA_M = 64
WGMMA_N = 8
WGMMA_N_MAX = 256


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Tensor-core GEMM tile — the Hopper 'scratchpad configuration'."""

    bm: int
    bn: int
    bk: int
    smem_bytes: int
    compute_s: float      # per-tile K step on one SM's share of the peak
    dma_s: float          # the same step's loads on one SM's share of HBM

    @property
    def compute_bound(self) -> bool:
        return self.compute_s >= self.dma_s

    @property
    def ideal_utilization(self) -> float:
        return min(1.0, self.compute_s / max(self.dma_s, 1e-30))


def tile_smem_bytes(bm: int, bn: int, bk: int, in_bytes: float) -> int:
    """Shared-memory working set (the reference's ``tile_vmem_bytes``):
    K1's ``TC_STAGES`` ring slots of the A and B panels.  The fp32 accumulator
    lives in the warpgroups' registers, not in shared memory, unlike the
    TPU's resident VMEM accumulator."""
    return int(TC_STAGES * (bm * bk + bk * bn) * in_bytes)


def tile_times(bm: int, bn: int, bk: int, dt: DataType,
               chip: GpuChip = TARGET_CHIP) -> "tuple[float, float]":
    """(tensor-core s, HBM s) of one K step of one block on one SM: the
    card's peak and HBM bandwidth, each divided by its SMs."""
    pol = policy(dt)
    peak = chip.peak_int8 if dt == DataType.INT8 else chip.peak_bf16
    compute_s = 2.0 * bm * bn * bk / (peak / chip.sms)
    dma_s = (bm * bk + bk * bn) * pol.bytes_per_elem / (chip.hbm_bw / chip.sms)
    return compute_s, dma_s


def solve_tiles(dt: DataType = DataType.BF16, chip: GpuChip = TARGET_CHIP,
                step: int = WGMMA_M) -> TileConfig:
    """Pick (bm, bn, bk) under Eq. 2 logic with Hopper constants.

    Grow the square output tile in ``step``s (whole warpgroups of M rows,
    so whole multiples of 8 in N) up to wgmma's N of 256, until compute
    per tile covers loads per tile, under one block's shared memory.
    The depth and the ring are K1's tensor-core tile's (``TC_BK`` = 64,
    ``TC_STAGES`` = 4); the reference's TPU default ``bk=512`` needs
    589,824 B at t = 128 by the reference's own working-set formula, and
    a block holds 232,448.  Returns the
    smallest tile that satisfies the constraint, else (bandwidth-bound)
    the largest that fits.
    """
    if step % WGMMA_M:
        raise ValueError(f"step {step} is not a whole number of "
                         f"{WGMMA_M}-row warpgroups")
    bk, budget, pol = TC_BK, chip.smem_per_block, policy(dt)
    best = None
    t = step
    while t <= WGMMA_N_MAX:
        sm = tile_smem_bytes(t, t, bk, pol.bytes_per_elem)
        if sm > budget:
            break
        c, d = tile_times(t, t, bk, dt, chip)
        best = TileConfig(t, t, bk, sm, c, d)
        if c >= d:          # constraint satisfied — smallest such tile
            return best
        t += step
    if best is None:
        raise ValueError("even the minimal tile exceeds the shared-memory "
                         "budget")
    return best             # bandwidth-bound: biggest tile that fits


# ---------------------------------------------------------------------------
# Level 2b: NVLink shard constraint (the cross-card reapplication).
# ---------------------------------------------------------------------------

def ici_gather_is_hidden(flops_per_chip: float, gather_bytes: float,
                         dt: DataType = DataType.BF16,
                         chip: GpuChip = TARGET_CHIP) -> bool:
    """Can an all-gather of ``gather_bytes`` over NVLink hide behind the
    matmul?  (The reference's name; its link is the TPU's ICI.)

    The distributed analogue of Eq. 2: collective time ≤ compute time
    means a weight-gathering sharding (e.g. ZeRO-3-style) costs nothing
    extra once overlapped; otherwise prefer keeping that operand resident
    (the 'scratchpad' at cluster scale is the card's HBM).
    """
    peak = chip.peak_int8 if dt == DataType.INT8 else chip.peak_bf16
    compute_s = flops_per_chip / peak
    link_s = gather_bytes / chip.nvlink_bw
    return link_s <= compute_s


def arithmetic_intensity_needed(dt: DataType = DataType.BF16,
                                chip: GpuChip = TARGET_CHIP) -> float:
    """FLOP/byte at which a card flips memory→compute bound (ridge point)."""
    peak = chip.peak_int8 if dt == DataType.INT8 else chip.peak_bf16
    return peak / chip.hbm_bw
