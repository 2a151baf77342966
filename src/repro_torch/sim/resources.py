"""A minimal discrete-event simulation kernel + resource primitives.

``EventLoop`` is a classic calendar-queue DES driver: callbacks are
scheduled at absolute times (cycles, floats) and run in time order, with
insertion order breaking ties — which keeps program order deterministic
when many tasks become ready in the same cycle.

``Resource`` is a capacity-limited server with a FIFO wait queue.  Every
occupancy is recorded as a ``(start, end, label)`` interval, which is
what the utilization report and the Chrome-trace exporter consume.  The
scratchpad's double-buffered banks are just a ``Resource`` with
``capacity = scratchpad_banks`` held across a tile's load+compute span.

``dram_stride_efficiency`` / ``contiguous_run_bytes`` model the DRAM
bandwidth a strided operand stream achieves (paper §5.4): the memory
loader walks an operand row by row, and each address jump between rows
costs part of a burst plus a row-activation bubble.  The platform's flat
``dram_efficiency`` is the DRAMSim-calibrated value for standard dense
tile panels (64-byte runs); runs at or above that reference stream at
the calibrated rate, shorter runs — a narrow tile cut from a wide
row-major matrix, i.e. ``MatMulTask.stride_b ≫ n`` — degrade sharply.

``BandwidthResource`` and ``ClusterTopology`` generalise the machine
beyond one matrix unit: a cluster is N units — each with its own
dispatcher, scratchpad banks, PE array and vector unit — contending for
one shared memory loader.  The loader partitions its bandwidth under a
configurable policy (``fair``: processor sharing, every in-flight
transfer streams at ``BW / n_active``; ``fcfs``: serial FIFO at full
bandwidth), which is exactly the contention knob multi-unit scale-out
studies (CAMP, arXiv 2504.08137) show decides delivered throughput.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from typing import Callable, Optional

# ---------------------------------------------------------------------------
# Stride-dependent DRAM efficiency (paper §5.4).
# ---------------------------------------------------------------------------

#: run length the platform's flat ``dram_efficiency`` is calibrated at —
#: one DRAM burst, the panel width of a standard dense int8 tile.
DRAM_REFERENCE_RUN_BYTES = 64.0
#: bandwidth lost per address jump (burst remainder + activation bubble),
#: expressed in stream-equivalent bytes.
DRAM_JUMP_GAP_BYTES = 16.0


def contiguous_run_bytes(rows: int, row_elems: int, stride_elems: int,
                         elem_bytes: float) -> float:
    """Longest contiguous burst a (rows × row_elems) operand read can
    sustain given its row stride: dense rows (stride == row length)
    merge into one run; a strided view jumps every ``row_elems``."""
    if rows <= 0 or row_elems <= 0:
        return 0.0
    if stride_elems <= row_elems:
        return rows * row_elems * elem_bytes
    return row_elems * elem_bytes


def dram_stride_efficiency(run_bytes: float, base_efficiency: float,
                           streams: int = 1) -> float:
    """Achieved/nominal DRAM bandwidth streaming contiguous runs of
    ``run_bytes`` between address jumps.

    The curve is ``run / (run + gap)`` normalised so the 64-byte
    reference run reproduces ``base_efficiency`` exactly (runs beyond it
    saturate there — dense streams are what the flat derate was
    calibrated on), while sub-burst runs degrade toward
    ``base * run / (run + gap) / 0.8``.

    ``streams`` carries the shared loader's **row-buffer state across
    interleaved streams** (``ClusterTopology.row_buffer``): N units
    drawing on one pool take turns on the memory channel, so each
    stream's bursts are chopped by the others' row activations and the
    contiguous run it actually sustains is ``run_bytes / N`` — one
    stream (the default) reproduces the single-unit curve exactly.
    """
    if run_bytes <= 0:
        return base_efficiency
    eff_run = run_bytes / max(1, streams)
    raw = eff_run / (eff_run + DRAM_JUMP_GAP_BYTES)
    ref = DRAM_REFERENCE_RUN_BYTES / (DRAM_REFERENCE_RUN_BYTES
                                      + DRAM_JUMP_GAP_BYTES)
    return base_efficiency * min(1.0, raw / ref)


class EventLoop:
    def __init__(self):
        self.now = 0.0
        self._heap: "list[tuple[float, int, Callable[[], None]]]" = []
        self._seq = 0

    def at(self, time: float, fn: Callable[[], None]) -> None:
        if time < self.now:
            raise ValueError(f"cannot schedule at {time} < now {self.now}")
        heapq.heappush(self._heap, (time, self._seq, fn))
        self._seq += 1

    def after(self, delay: float, fn: Callable[[], None]) -> None:
        self.at(self.now + delay, fn)

    def run(self, max_events: int = 50_000_000) -> float:
        n = 0
        while self._heap:
            self.now, _, fn = heapq.heappop(self._heap)
            fn()
            n += 1
            if n > max_events:
                raise RuntimeError("event budget exhausted (cycle in graph?)")
        return self.now


class Resource:
    """``capacity`` concurrent holders; FIFO beyond that."""

    def __init__(self, loop: EventLoop, name: str, capacity: int = 1):
        self.loop = loop
        self.name = name
        self.capacity = capacity
        self._free = capacity
        self._waiters: "deque[Callable[[], None]]" = deque()
        self.intervals: "list[tuple[float, float, str]]" = []

    # -- raw acquire / release ---------------------------------------------
    def acquire(self, fn: Callable[[], None]) -> None:
        """Call ``fn`` (same tick or later) once a slot is held."""
        if self._free > 0:
            self._free -= 1
            fn()
        else:
            self._waiters.append(fn)

    def release(self) -> None:
        if self._waiters:
            self._waiters.popleft()()
        else:
            self._free += 1
            if self._free > self.capacity:
                raise RuntimeError(f"{self.name}: release without acquire")

    # -- the common occupy-for-duration pattern -----------------------------
    def busy(self, duration: float, label: str,
             then: Optional[Callable[[], None]] = None) -> None:
        """Acquire → hold for ``duration`` → release → ``then()``."""

        def _granted():
            start = self.loop.now

            def _done():
                self.intervals.append((start, self.loop.now, label))
                self.release()
                if then is not None:
                    then()

            self.loop.after(duration, _done)

        self.acquire(_granted)


# ---------------------------------------------------------------------------
# Shared-bandwidth server: the cluster's one memory loader.
# ---------------------------------------------------------------------------

class _Flow:
    __slots__ = ("work_left", "label", "then", "start")

    def __init__(self, work, label, then, start):
        self.work_left = work
        self.label = label
        self.then = then
        self.start = start


class BandwidthResource:
    """A bandwidth server shared by many clients.

    A *transfer* is expressed in **work units** — cycles the transfer
    would take with the full bandwidth to itself (so per-operand stride
    derates are already folded in by the caller).  Two partition
    policies:

    * ``"fair"`` — processor sharing: every in-flight transfer streams
      at ``1 / n_active`` of the bandwidth, the hardware idealisation of
      a round-robin/interleaved DRAM controller.  A transfer that would
      take T cycles alone takes up to ``n·T`` under n-way contention.
    * ``"fcfs"`` — serial FIFO at full bandwidth: one transfer at a
      time, later arrivals queue.  With one client this is exactly the
      classic single-unit ``Resource`` loader.

    ``intervals`` records per-transfer ``(start, end, label)`` spans for
    the trace (overlapping under ``fair``); ``busy_intervals`` records
    the union busy periods of the server, which is what utilization /
    saturation should be judged on.
    """

    def __init__(self, loop: EventLoop, name: str, policy: str = "fair"):
        if policy not in ("fair", "fcfs"):
            raise ValueError(f"unknown loader policy {policy!r}; "
                             "use 'fair' or 'fcfs'")
        self.loop = loop
        self.name = name
        self.policy = policy
        self.capacity = 1
        self.intervals: "list[tuple[float, float, str]]" = []
        self.busy_intervals: "list[tuple[float, float, str]]" = []
        # fair-share state
        self._active: "list[_Flow]" = []
        self._last_t = 0.0
        self._epoch = 0
        self._busy_since: Optional[float] = None
        # fcfs state
        self._fifo = Resource(loop, name) if policy == "fcfs" else None

    def transfer(self, work: float, label: str,
                 then: Optional[Callable[[], None]] = None) -> None:
        """Stream ``work`` (full-bandwidth cycles) through the loader."""
        if self.policy == "fcfs":
            self._fcfs_transfer(work, label, then)
            return
        self._settle()
        if not self._active:
            self._busy_since = self.loop.now
        self._active.append(_Flow(max(work, 0.0), label, then,
                                  self.loop.now))
        self._reschedule()

    # -- fcfs ---------------------------------------------------------------
    def _fcfs_transfer(self, work, label, then):
        # Resource.busy with both interval lists populated.
        def _granted():
            start = self.loop.now

            def _end():
                self.intervals.append((start, self.loop.now, label))
                self.busy_intervals.append((start, self.loop.now, label))
                self._fifo.release()
                if then is not None:
                    then()

            self.loop.after(work, _end)

        self._fifo.acquire(_granted)

    # -- fair share ---------------------------------------------------------
    def _settle(self) -> None:
        """Advance every in-flight transfer to ``now`` at the shared rate."""
        dt = self.loop.now - self._last_t
        if dt > 0 and self._active:
            rate = 1.0 / len(self._active)
            for f in self._active:
                f.work_left -= dt * rate
        self._last_t = self.loop.now

    def _reschedule(self) -> None:
        self._epoch += 1
        if not self._active:
            return
        rate = 1.0 / len(self._active)
        t_next = min(f.work_left for f in self._active) / rate
        epoch = self._epoch
        self.loop.after(max(t_next, 0.0), lambda: self._fire(epoch))

    def _fire(self, epoch: int) -> None:
        if epoch != self._epoch:            # superseded by a newer arrival
            return
        self._settle()
        done = [f for f in self._active if f.work_left <= 1e-9]
        self._active = [f for f in self._active if f.work_left > 1e-9]
        now = self.loop.now
        for f in done:
            self.intervals.append((f.start, now, f.label))
        if not self._active and self._busy_since is not None:
            self.busy_intervals.append((self._busy_since, now, "busy"))
            self._busy_since = None
        self._reschedule()
        for f in done:                       # callbacks may start new flows
            if f.then is not None:
                f.then()

    def busy_cycles(self) -> float:
        """Union busy time (in-flight tail included)."""
        tail = 0.0
        if self.policy == "fair" and self._busy_since is not None:
            tail = self.loop.now - self._busy_since
        return sum(e - s for s, e, _ in self.busy_intervals) + tail


# ---------------------------------------------------------------------------
# Cluster topology: N matrix units behind one shared loader.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class UnitSpec:
    """One matrix unit's slot in a (possibly heterogeneous) cluster.

    ``unit`` is the full :class:`~repro_torch.core.config.MatrixUnitConfig`
    (PE array shape, scratchpad extents and bank count, memory channel),
    so per-unit PE throughput and scratchpad capacity are just distinct
    configs.  ``private_bandwidth`` carves a NUMA-ish dedicated slice out
    of the pooled loader bandwidth: the unit's own tile loads/writebacks
    stream through that slice uncontended while cross-unit transfers and
    bulk memory nodes (and every unit without a slice) share the
    remainder of the pool.
    """

    unit: object = None               # MatrixUnitConfig (default CASE_STUDY)
    private_bandwidth: float = 0.0    # bytes/s carved out of the pool

    def __post_init__(self):
        if self.unit is None:
            from repro_torch.core.config import CASE_STUDY
            object.__setattr__(self, "unit", CASE_STUDY)
        if self.private_bandwidth < 0:
            raise ValueError(
                f"private_bandwidth must be >= 0, got "
                f"{self.private_bandwidth}")


@dataclasses.dataclass(frozen=True)
class ClusterTopology:
    """The machine a multi-unit deployment implies (scale-out mirror of
    ``MatrixUnitConfig``): ``n_units`` matrix units, each with a private
    dispatcher, scratchpad banks, PE array and vector unit, all loading
    through one shared memory loader.

    Homogeneous clusters pass ``n_units`` + one ``unit`` config (the
    classic form); heterogeneous clusters pass ``unit_specs`` — a list
    of :class:`UnitSpec` (or bare ``MatrixUnitConfig``) entries with
    distinct PE throughput / scratchpad / private-bandwidth slices.
    All units must share one clock (``freq_hz``) so cycle counts remain
    a common currency across the cluster.

    ``total_bandwidth`` is the pooled loader bandwidth.  The default
    (``None``) assumes every unit brings its own memory channel into the
    pool — ``Σ unit.bandwidth`` — so weak scaling is limited by
    *contention/interleaving*, not raw starvation; pass a fixed value to
    study where the shared loader saturates.  Private slices
    (``UnitSpec.private_bandwidth``) are carved out of that pool; the
    remainder (:attr:`shared_bandwidth`) is what contended traffic sees.

    ``k_stream`` enables K-chunked scratchpad streaming (``k_scp``
    granularity): a tile's loads arrive chunk by chunk and its compute
    starts after the first chunk, overlapping fill with compute inside a
    single tile (ROADMAP DES-fidelity item).
    """

    n_units: int = 1
    unit: object = None               # MatrixUnitConfig (default CASE_STUDY)
    platform: object = None           # CpuPlatform (default SHUTTLE)
    vector: object = None             # VectorUnit (default SATURN_512)
    loader_policy: str = "fair"       # "fair" | "fcfs"
    total_bandwidth: Optional[float] = None
    k_stream: bool = True
    #: model the shared loader's row-buffer state across the units'
    #: interleaved operand streams: each shared-pool stream's contiguous
    #: runs are chopped by the others (``dram_stride_efficiency``'s
    #: ``streams`` knob).  Off by default — the flat calibrated derate.
    row_buffer: bool = False
    unit_specs: "Optional[tuple]" = None   # heterogeneous per-unit specs

    def __post_init__(self):
        if self.unit_specs is not None:
            specs = tuple(s if isinstance(s, UnitSpec) else UnitSpec(unit=s)
                          for s in self.unit_specs)
            if not specs:
                raise ValueError("unit_specs must name at least one unit")
            # n_units left at its default follows the spec list; an
            # explicit mismatching width is a caller bug.
            if self.n_units not in (1, len(specs)):
                raise ValueError(
                    f"n_units={self.n_units} but unit_specs has "
                    f"{len(specs)} entries")
            object.__setattr__(self, "unit_specs", specs)
            object.__setattr__(self, "n_units", len(specs))
            object.__setattr__(self, "unit", self.unit or specs[0].unit)
        if self.n_units < 1:
            raise ValueError(f"n_units must be >= 1, got {self.n_units}")
        if self.loader_policy not in ("fair", "fcfs"):
            raise ValueError(
                f"unknown loader policy {self.loader_policy!r}")
        if self.unit is None or self.platform is None or self.vector is None:
            from repro_torch.core.config import CASE_STUDY
            from repro_torch.core.hardware import SHUTTLE
            from repro_torch.core.simulator import SATURN_512
            object.__setattr__(self, "unit", self.unit or CASE_STUDY)
            object.__setattr__(self, "platform", self.platform or SHUTTLE)
            object.__setattr__(self, "vector", self.vector or SATURN_512)
        freqs = {self.unit_config(i).freq_hz for i in range(self.n_units)}
        if len(freqs) > 1:
            raise ValueError(
                f"units must share one clock; got freq_hz={sorted(freqs)}")
        if self.private_total > 0 and self.shared_bandwidth <= 0:
            raise ValueError(
                f"private slices ({self.private_total:.3g} B/s) consume "
                f"the whole pool ({self.loader_bandwidth:.3g} B/s); "
                "shrink them or raise total_bandwidth")

    # ----- per-unit accessors ---------------------------------------------
    @property
    def heterogeneous(self) -> bool:
        return self.unit_specs is not None

    def spec(self, i: int) -> UnitSpec:
        if self.unit_specs is not None:
            return self.unit_specs[i]
        return UnitSpec(unit=self.unit)

    def unit_config(self, i: int):
        return self.spec(i).unit

    def private_bandwidth(self, i: int) -> float:
        return self.spec(i).private_bandwidth

    @property
    def private_total(self) -> float:
        return sum(self.private_bandwidth(i) for i in range(self.n_units))

    def throughput_weights(self, data_type=None) -> "list[float]":
        """Relative per-unit MAC throughput — the balance weights a
        heterogeneity-aware partitioner (``unit-affinity``) uses."""
        from repro_torch.core.precision import DataType
        dt = data_type or DataType.INT8
        return [float(self.unit_config(i).macs_per_cycle(dt))
                for i in range(self.n_units)]

    # ----- bandwidth accounting -------------------------------------------
    @property
    def loader_bandwidth(self) -> float:
        if self.total_bandwidth is not None:
            return self.total_bandwidth
        return sum(self.unit_config(i).bandwidth
                   for i in range(self.n_units))

    @property
    def shared_bandwidth(self) -> float:
        """Pool left for contended traffic after private slices."""
        return self.loader_bandwidth - self.private_total

    def interleaved_streams(self) -> int:
        """Streams whose interleaving degrades the shared pool's
        row-buffer locality: the units *without* a private slice when
        ``row_buffer`` modelling is on, else 1 (each transfer sees the
        calibrated single-stream curve)."""
        if not self.row_buffer:
            return 1
        return max(1, sum(1 for i in range(self.n_units)
                          if self.private_bandwidth(i) <= 0))

    def with_(self, **kw) -> "ClusterTopology":
        return dataclasses.replace(self, **kw)

    def describe(self) -> str:
        from repro_torch.core.hardware import GIGA
        if self.heterogeneous:
            units = " + ".join(
                f"[{s.unit.describe()}"
                + (f", {s.private_bandwidth / GIGA:.0f} GB/s private]"
                   if s.private_bandwidth else "]")
                for s in self.unit_specs)
        else:
            units = f"{self.n_units} unit(s) x [{self.unit.describe()}]"
        return (f"{units}, shared loader "
                f"{self.shared_bandwidth / GIGA:.0f} GB/s "
                f"({self.loader_policy})"
                + (", k-stream" if self.k_stream else ""))
