"""Three-term roofline model on one card.

    compute   = FLOPs        / peak_FLOP/s           (per card)
    memory    = bytes        / HBM_bw                (per card)
    collective= coll_bytes   / NVLink_bw             (per card)

The reference's (``repro.core.roofline``) over a ``GpuChip``: the compute
term reads ``peak_bf16`` (or ``peak_int8``), the memory term ``hbm_bw``
and the collective term ``nvlink_bw``, the card's aggregate, as the
reference's reads its chip's ``ici_bw_total``.  FLOPs and bytes come from
the port's cost counter (``core.hlo_cost``), which counts one process's
step, so every term is per card; the dry-run JSON also records the
whole job's model FLOPs.  Collective bytes are the counter's
``per_collective`` (the reference parses them from HLO text).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.hardware import TARGET_CHIP, GpuChip


def collective_bytes(per_collective: "dict[str, float]") -> "dict[str, float]":
    """Result-shape bytes of the collectives by kind, with their
    ``total``: a counter's ``per_collective`` (``HloCost``)."""
    per_kind = {k: float(v) for k, v in per_collective.items()
                if k != "total"}
    per_kind["total"] = sum(per_kind.values())
    return per_kind


@dataclasses.dataclass(frozen=True)
class Roofline:
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    chips: int
    model_flops_per_chip: float      # 6·N·D (dense) / 6·N_active·D (MoE), per chip
    chip: GpuChip = TARGET_CHIP
    dtype_peak: str = "bf16"

    @property
    def peak(self) -> float:
        return (self.chip.peak_int8 if self.dtype_peak == "int8"
                else self.chip.peak_bf16)

    @property
    def compute_s(self) -> float:
        return self.flops_per_chip / self.peak

    @property
    def memory_s(self) -> float:
        return self.bytes_per_chip / self.chip.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_per_chip / self.chip.nvlink_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs — catches remat / redundancy waste."""
        return (self.model_flops_per_chip / self.flops_per_chip
                if self.flops_per_chip else 0.0)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / achievable step time (the score)."""
        useful_s = self.model_flops_per_chip / self.peak
        return useful_s / self.bound_s if self.bound_s else 0.0

    def as_dict(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "model_flops_per_chip": self.model_flops_per_chip,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "chips": self.chips,
        }
