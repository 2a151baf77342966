"""The autotuner's search space: kernel variants and shape buckets.

One candidate is a :class:`TunedConfig` — the software-visible knobs the
paper's configurable matrix unit leaves to the stack: the scratchpad
tile the GEMM is cut into (``tile_m``/``tile_n``, at most the platform's
``m_scp``/``n_scp``), the epilogue granularity (``tile | panel |
layer``), K-chunked scratchpad streaming (``k_stream``), epilogue fusion
on/off, and — for whole serving schedules — the step-overlap lowering
mode (``chained | relaxed``).  ``TunedConfig()`` with no arguments *is*
the untuned default every backend constructs with, so "tuned beats
default" is a comparison inside one space.

Winners are cached per (platform × shape bucket): :func:`shape_bucket`
classifies a GEMM by its row count (decode steps feed skinny M, prefill
feeds deep M — the regimes the paper's Fig. 6/Table 6 separate), and
:func:`schedule_bucket` classifies a serving ``BatchSchedule`` by its
repeat-weighted decode share plus the cluster width it targets.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

#: decode steps enter the projection GEMMs with one row per in-flight
#: sequence; anything at or under this M is priced as the decode regime.
DECODE_MAX_M = 32


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """One kernel variant — the no-argument instance is the untuned
    default (scratchpad-sized tiles, tile granularity, fused epilogues,
    K-streaming on, caller-chosen overlap)."""

    tile_m: Optional[int] = None        # None: the unit's full m_scp
    tile_n: Optional[int] = None        # None: the unit's full n_scp
    granularity: str = "tile"
    fused: bool = True
    k_stream: bool = True
    overlap: Optional[str] = None       # schedules only; None: caller's
    #: executing ``cute_matmul`` route ("xla" | "pallas" | "auto") this
    #: variant pins for the shape class; None: the zoo-wide default.
    #: Not searched by the autotuner (wall-clock under interpret mode is
    #: not the machine being modelled) — hand-pinnable in a cache file.
    route: Optional[str] = None

    def backend_kwargs(self, unit, platform=None) -> dict:
        """Backend-constructor kwargs this variant implies.  ``unit`` is
        the platform's matrix-unit geometry; a sub-scratchpad tile is
        applied as a ``with_()`` override, so every backend (and both
        graph lowerings) inherits it through the one ``unit`` field.
        ``k_stream`` only reaches backends that accept it — the registry
        dispatch layer drops it for single-unit engines."""
        u = unit
        if self.tile_m is not None or self.tile_n is not None:
            u = unit.with_(m_scp=self.tile_m or unit.m_scp,
                           n_scp=self.tile_n or unit.n_scp)
        kw = dict(unit=u, granularity=self.granularity, fused=self.fused,
                  k_stream=self.k_stream)
        if platform is not None:
            kw["platform"] = platform
        return kw

    def to_dict(self) -> dict:
        """JSON form — only non-default fields, so cache files stay
        small and the default round-trips to ``{}``."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v != f.default:
                out[f.name] = v
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "TunedConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        bad = set(d) - known
        if bad:
            raise ValueError(f"unknown TunedConfig fields {sorted(bad)}; "
                             f"known: {sorted(known)}")
        return cls(**d)


#: the untuned default — what every dispatch falls back to.
DEFAULT_CONFIG = TunedConfig()


def shape_bucket(m: int, n: int, k: int) -> str:
    """Classify one GEMM shape: ``"decode"`` for skinny-M projection
    GEMMs (one row per in-flight sequence), ``"prefill"`` for everything
    with real row parallelism.  ``n``/``k`` are accepted for forward
    compatibility; today M alone separates the serving regimes."""
    del n, k
    return "decode" if m <= DECODE_MAX_M else "prefill"


def bucket_of_task(task) -> str:
    """:func:`shape_bucket` of a ``MatMulTask``, keyed for the cache."""
    return f"gemm|{shape_bucket(task.m, task.n, task.k)}"


def schedule_bucket(sched) -> str:
    """Cache key of a serving ``BatchSchedule``: cluster width plus
    whether the drain is decode- or prefill-dominated by repeat-weighted
    step count (decode steps repeat ``n_layers × iterations``, so a
    modest ``max_new_tokens`` already tips a queue decode-heavy).

    Schedules carrying KV refill traffic (``refill_bytes`` stamped by a
    residency-aware plan) get a ``|kv`` suffix: a loader already paying
    refill bytes favours different tile/overlap trade-offs than the
    all-resident regime, so tuned entries must not leak across."""
    decode = sum(s.repeat for s in sched.steps
                 if s.kind == "decode" or s.decode_requests)
    prefill = sum(s.repeat for s in sched.steps
                  if not (s.kind == "decode" or s.decode_requests))
    regime = "decode" if decode >= prefill else "prefill"
    kv = "|kv" if any(getattr(sched, "refill_bytes", ()) or ()) else ""
    return f"sched|u{sched.units}|{regime}{kv}"


def _tile_choices(unit) -> "list[tuple[Optional[int], Optional[int]]]":
    """(tile_m, tile_n) candidates: the full scratchpad tile plus the
    half-size cuts in each dimension (smaller tiles trade loader burst
    length against dispatch-stream pressure — the CSR-vs-RoCC axis)."""
    out = [(None, None)]
    half_m = unit.m_scp // 2
    half_n = unit.n_scp // 2
    if half_m >= unit.m_pe:
        out.append((half_m, None))
    if half_n >= unit.n_pe:
        out.append((None, half_n))
    if half_m >= unit.m_pe and half_n >= unit.n_pe:
        out.append((half_m, half_n))
    return out


def gemm_candidates(unit) -> "list[TunedConfig]":
    """The GEMM-bucket search space, deterministically ordered with the
    untuned default first (rank ties resolve toward the default)."""
    out = [DEFAULT_CONFIG]
    for tile_m, tile_n in _tile_choices(unit):
        for gran in ("tile", "panel", "layer"):
            for fused in (True, False):
                for k_stream in (True, False):
                    cfg = TunedConfig(tile_m=tile_m, tile_n=tile_n,
                                      granularity=gran, fused=fused,
                                      k_stream=k_stream)
                    if cfg != DEFAULT_CONFIG:
                        out.append(cfg)
    return out


def schedule_candidates(unit) -> "list[TunedConfig]":
    """The schedule-bucket space: the GEMM knobs that matter at schedule
    scale (granularity × fusion × K-streaming) crossed with the overlap
    lowering mode.  Tile cuts are left to the GEMM buckets — a serving
    step's skinny GEMMs rarely fill even one scratchpad tile."""
    del unit
    out = [DEFAULT_CONFIG]
    for overlap in (None, "relaxed"):
        for gran in ("tile", "panel", "layer"):
            for fused in (True, False):
                for k_stream in (True, False):
                    cfg = TunedConfig(granularity=gran, fused=fused,
                                      k_stream=k_stream, overlap=overlap)
                    if cfg != DEFAULT_CONFIG:
                        out.append(cfg)
    return out
