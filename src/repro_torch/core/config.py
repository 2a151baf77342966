"""Configurable matrix-unit parameters (paper Table 2) and Eq. 1.

``MatrixUnitConfig`` is the generator record of the paper: a PE array
``M_pe × N_pe`` where each PE reduces ``K_pe`` bits per cycle, a
scratchpad bounded by ``(M_scp, N_scp, K_scp)``, and the bandwidth the
surrounding SoC can feed it.  ``throughput()`` is Eq. 1 verbatim.

Presets cover the paper's case study (Table 2, Intel-AMX-comparable)
and the 2 TOPS unit of the four integration platforms.  The Eq. 2
scaling sweep (``scaled_config``) needs the constraint solver, which the
port has not carried over yet.
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
