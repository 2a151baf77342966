"""Configurable matrix-unit parameters (paper Table 2) and Eq. 1.

``MatrixUnitConfig`` is the generator record of the paper: a PE array
``M_pe × N_pe`` where each PE reduces ``K_pe`` bits per cycle, a
scratchpad bounded by ``(M_scp, N_scp, K_scp)``, and the bandwidth the
surrounding SoC can feed it.  ``throughput()`` is Eq. 1 verbatim.

Presets cover the paper's case study (Table 2, Intel-AMX-comparable),
the scaling sweep of Table 4 (2×2 … 16×16 PE arrays, 256/512-bit reduce,
8–64 GB/s), and the 0.5–32 TOPS envelope claimed in §1.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.hardware import GIGA, TERA
from repro_torch.core.precision import DataType, policy


@dataclasses.dataclass(frozen=True)
class MatrixUnitConfig:
    """Paper Table 2 — configurable architectural parameters."""

    freq_hz: float = 2.0 * GIGA
    m_pe: int = 4                 # rows of PE array
    n_pe: int = 4                 # cols of PE array
    k_pe_bits: int = 512          # per-PE reduce width (bits/cycle)
    m_scp: int = 64               # max resident M in scratchpad
    n_scp: int = 64               # max resident N in scratchpad
    k_scp_bytes: int = 64         # max resident K in scratchpad (bytes)
    bandwidth: float = 48 * GIGA  # data-supply bandwidth (bytes/s)
    scratchpad_banks: int = 2     # double buffering (paper §4.1)
    accum_bytes: int = 4          # resident C is fp32/int32
    pe_pipeline_stages: int = 6   # paper §4.1: six-stage PE pipeline

    # ----- Eq. 1 ----------------------------------------------------------
    def k_pe_elems(self, data_type: DataType) -> int:
        """Elements reduced per PE per cycle for an n-bit format."""
        bits = policy(data_type).bits
        return self.k_pe_bits // bits

    def macs_per_cycle(self, data_type: DataType) -> int:
        return self.m_pe * self.n_pe * self.k_pe_elems(data_type)

    def throughput(self, data_type: DataType = DataType.INT8) -> float:
        """Eq. 1: ``Freq × M_pe × N_pe × (K_pe/n) × 2`` ops/s."""
        return self.freq_hz * self.macs_per_cycle(data_type) * 2

    # ----- scratchpad -----------------------------------------------------
    def scratchpad_bytes(self) -> int:
        """Total SRAM the configuration implies (A+B double-buffered, C resident)."""
        a = self.m_scp * self.k_scp_bytes
        b = self.n_scp * self.k_scp_bytes
        c = self.m_scp * self.n_scp * self.accum_bytes
        return self.scratchpad_banks * (a + b) + c

    def bytes_per_cycle(self) -> float:
        return self.bandwidth / self.freq_hz

    def with_(self, **kw) -> "MatrixUnitConfig":
        return dataclasses.replace(self, **kw)

    def describe(self) -> str:
        tops = self.throughput(DataType.INT8) / TERA
        return (f"{self.m_pe}x{self.n_pe} PE, K_pe={self.k_pe_bits}b, "
                f"scp=({self.m_scp},{self.n_scp},{self.k_scp_bytes}B), "
                f"{self.bandwidth / GIGA:.0f} GB/s -> {tops:.2f} TOPS(int8)")


# ---------------------------------------------------------------------------
# Presets.
# ---------------------------------------------------------------------------

#: Paper Table 2 case study — compute/bandwidth comparable to Xeon 8580 AMX.
CASE_STUDY = MatrixUnitConfig()
assert abs(CASE_STUDY.throughput(DataType.INT8) - 4.096 * TERA) < 1e9

#: §5.2 — the four integration platforms all run a 2 TOPS unit.
PLATFORM_2TOPS = MatrixUnitConfig(k_pe_bits=256, m_scp=64, n_scp=64,
                                  bandwidth=48 * GIGA)
assert abs(PLATFORM_2TOPS.throughput(DataType.INT8) - 2.048 * TERA) < 1e9


def scaled_config(m_pe: int, n_pe: int, k_pe_bits: int,
                  bandwidth: float) -> MatrixUnitConfig:
    """Build a Table-4 style configuration; scratchpad sized by Eq. 2.

    Import is deferred to avoid a cycle: constraint.py needs the config
    class defined above.
    """
    from repro_torch.core.constraint import solve_scratchpad

    base = MatrixUnitConfig(m_pe=m_pe, n_pe=n_pe, k_pe_bits=k_pe_bits,
                            bandwidth=bandwidth)
    m_scp, n_scp = solve_scratchpad(base, DataType.INT8)
    return base.with_(m_scp=m_scp, n_scp=n_scp)


#: §1 claims a 0.5–32 TOPS envelope; Table 4 gives the PE sweep.
def scaling_sweep() -> "list[MatrixUnitConfig]":
    sweep = []
    for (m, n), kbits, bw in [
        ((2, 2), 256, 8 * GIGA),     # 0.512 TOPS embedded
        ((4, 4), 256, 16 * GIGA),    # 2.048 TOPS
        ((4, 4), 512, 48 * GIGA),    # 4.096 TOPS (case study class)
        ((8, 8), 512, 64 * GIGA),    # 16.4 TOPS
        ((16, 16), 512, 64 * GIGA),  # 65.5 TOPS upper stress point
    ]:
        sweep.append(scaled_config(m, n, kbits, bw))
    return sweep
