"""Area / power model calibrated to paper Table 7 (14 nm, 2 GHz).

Table 7 for the 4 TOPS case study (4×4 PEs × 512-bit reduce = 1024 int8
MACs; ~96 KiB of scratchpad incl. double buffers and the fp32 accumulator
bank plus loader/reorder FIFOs):

    RAM    0.164 mm²   0.784 W
    Logic  0.367 mm²   0.722 W
    Total  0.531 mm²   1.506 W

We fit a two-parameter linear model (area/bit of SRAM, area/MAC of
datapath+control) on that single calibration point and use it to predict
the cost of other configurations — in particular the Eq.2-saturating
128×128 scratchpad variant explored in EXPERIMENTS.md §Perf (hardware
side), and the 0.5–32 TOPS envelope of §1.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.config import CASE_STUDY, MatrixUnitConfig
from repro_torch.core.precision import DataType

# Calibration constants derived from Table 7 / the case-study config.
_CASE_BITS = CASE_STUDY.scratchpad_bytes() * 8          # scratchpad bits
_FIFO_OVERHEAD = 1.25                                   # loader/reorder FIFOs
_RAM_MM2_PER_BIT = 0.164 / (_CASE_BITS * _FIFO_OVERHEAD)
_CASE_MACS = CASE_STUDY.macs_per_cycle(DataType.INT8)   # 1024 int8 MACs
_LOGIC_MM2_PER_MAC = 0.367 / _CASE_MACS
_RAM_W_PER_BIT = 0.784 / (_CASE_BITS * _FIFO_OVERHEAD)
_LOGIC_W_PER_MAC = 0.722 / _CASE_MACS


@dataclasses.dataclass(frozen=True)
class AreaPower:
    ram_mm2: float
    logic_mm2: float
    ram_w: float
    logic_w: float

    @property
    def total_mm2(self) -> float:
        return self.ram_mm2 + self.logic_mm2

    @property
    def total_w(self) -> float:
        return self.ram_w + self.logic_w


def estimate(cfg: MatrixUnitConfig) -> AreaPower:
    bits = cfg.scratchpad_bytes() * 8 * _FIFO_OVERHEAD
    macs = cfg.macs_per_cycle(DataType.INT8)
    freq_scale = cfg.freq_hz / CASE_STUDY.freq_hz    # dynamic power ~ f
    return AreaPower(
        ram_mm2=bits * _RAM_MM2_PER_BIT,
        logic_mm2=macs * _LOGIC_MM2_PER_MAC,
        ram_w=bits * _RAM_W_PER_BIT * freq_scale,
        logic_w=macs * _LOGIC_W_PER_MAC * freq_scale,
    )
