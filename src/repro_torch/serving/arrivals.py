"""Arrival processes driving the online serving loop.

The offline ``ServingEngine.plan`` assumes the whole queue is known at
t = 0; :mod:`repro_torch.serving.online` replaces that with a *stream*: an
arrival source yields :class:`Arrival` records (cycle-stamped, in
non-decreasing time order) and the event loop admits them as the
simulated clock reaches them.  Three sources cover the usual load
shapes:

* :class:`PoissonArrivals` — seeded memoryless traffic (exponential
  inter-arrival gaps), the open-loop load model every QPS sweep uses;
* :class:`DeterministicArrivals` — fixed inter-arrival gap, the
  constant-rate control every comparison needs;
* :class:`TraceArrivals` — a JSONL trace file (one
  ``{"time": …, "prompt_len": …}`` object per line), for replaying
  recorded traffic.

Determinism is a hard contract: sources draw only from
:class:`random.Random` (whose Mersenne-Twister stream is pinned across
platforms and Python versions), materialise their sequence once, and
return the identical tuple on every call — same seed, bit-identical
admission sequence, regardless of which pricing backend the loop plans
with (pinned in ``tests/test_online.py``).

All times are **cycles** of the simulated machine — the currency every
backend prices in.  :func:`qps_to_gap` converts an offered
requests-per-second rate into a mean inter-arrival gap for a unit
clocked at ``freq_hz``.
"""

from __future__ import annotations

import dataclasses
import json
import random
from typing import Iterable, Iterator, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One request arriving at the serving loop.

    ``time`` is the arrival cycle; ``prompt_len`` the prompt length in
    tokens (the quantity scheduling actually consumes — concrete token
    ids are synthesised downstream when a run executes for real).
    """

    time: float
    prompt_len: int

    def __post_init__(self):
        if self.time < 0:
            raise ValueError(f"arrival time must be >= 0, got {self.time}")
        if self.prompt_len < 1:
            raise ValueError(f"prompt_len must be >= 1, "
                             f"got {self.prompt_len}")


def qps_to_gap(qps: float, freq_hz: float) -> float:
    """Mean inter-arrival gap (cycles) of an offered ``qps`` rate on a
    machine clocked at ``freq_hz``: ``freq_hz / qps``."""
    if qps <= 0:
        raise ValueError(f"qps must be > 0, got {qps}")
    return freq_hz / qps


def gap_to_qps(gap_cycles: float, freq_hz: float) -> float:
    """Offered requests/second of a mean ``gap_cycles`` inter-arrival
    gap — the inverse of :func:`qps_to_gap`."""
    if gap_cycles <= 0:
        raise ValueError(f"gap_cycles must be > 0, got {gap_cycles}")
    return freq_hz / gap_cycles


class ArrivalSource:
    """Base class: a finite, materialised, re-iterable arrival stream.

    Subclasses implement :meth:`_generate` (called once, lazily); the
    base caches the tuple so a source can be iterated any number of
    times and always yields the identical sequence — the determinism
    audit the online tests pin.
    """

    def _generate(self) -> "list[Arrival]":
        raise NotImplementedError

    def arrivals(self) -> "tuple[Arrival, ...]":
        cached = getattr(self, "_cache", None)
        if cached is None:
            out = list(self._generate())
            for prev, cur in zip(out, out[1:]):
                if cur.time < prev.time:
                    raise ValueError(
                        f"arrival times must be non-decreasing "
                        f"({cur.time} after {prev.time})")
            cached = tuple(out)
            object.__setattr__(self, "_cache", cached)
        return cached

    def __iter__(self) -> Iterator[Arrival]:
        return iter(self.arrivals())

    def __len__(self) -> int:
        return len(self.arrivals())


def _prompt_picker(prompt_lengths, rng: random.Random,
                   min_prompt: int, max_prompt: int):
    """Per-arrival prompt lengths: cycle a given sequence, or draw
    uniform ints from the source's own RNG stream (one draw per
    arrival, *after* the gap draw — the draw order is part of the
    determinism contract)."""
    if prompt_lengths is not None:
        seq = tuple(int(p) for p in prompt_lengths)
        if not seq:
            raise ValueError("prompt_lengths must be non-empty")
        return lambda i: seq[i % len(seq)]
    if not 1 <= min_prompt <= max_prompt:
        raise ValueError(f"need 1 <= min_prompt <= max_prompt, got "
                         f"[{min_prompt}, {max_prompt}]")
    return lambda i: rng.randint(min_prompt, max_prompt)


@dataclasses.dataclass(frozen=True)
class PoissonArrivals(ArrivalSource):
    """Seeded Poisson process: exponential inter-arrival gaps with mean
    ``mean_gap`` cycles, ``n`` arrivals total.  ``prompt_lengths``
    cycles a fixed tuple; omitted, lengths are uniform draws in
    ``[min_prompt, max_prompt]`` from the same seeded stream."""

    mean_gap: float
    n: int
    seed: int = 0
    prompt_lengths: "Optional[tuple[int, ...]]" = None
    min_prompt: int = 16
    max_prompt: int = 128

    def __post_init__(self):
        if self.mean_gap <= 0:
            raise ValueError(f"mean_gap must be > 0, got {self.mean_gap}")
        if self.n < 1:
            raise ValueError(f"n must be >= 1, got {self.n}")

    def _generate(self) -> "list[Arrival]":
        rng = random.Random(self.seed)
        pick = _prompt_picker(self.prompt_lengths, rng,
                              self.min_prompt, self.max_prompt)
        out, t = [], 0.0
        for i in range(self.n):
            t += rng.expovariate(1.0 / self.mean_gap)
            out.append(Arrival(time=t, prompt_len=pick(i)))
        return out


@dataclasses.dataclass(frozen=True)
class DeterministicArrivals(ArrivalSource):
    """Constant-rate traffic: arrival *i* at ``(i + 1) * gap`` cycles
    (``gap=0`` puts the whole queue at t = 0 — the offline limit)."""

    gap: float
    n: int
    prompt_lengths: "Optional[tuple[int, ...]]" = None
    min_prompt: int = 16
    max_prompt: int = 128
    seed: int = 0

    def __post_init__(self):
        if self.gap < 0:
            raise ValueError(f"gap must be >= 0, got {self.gap}")
        if self.n < 1:
            raise ValueError(f"n must be >= 1, got {self.n}")

    def _generate(self) -> "list[Arrival]":
        rng = random.Random(self.seed)
        pick = _prompt_picker(self.prompt_lengths, rng,
                              self.min_prompt, self.max_prompt)
        return [Arrival(time=(i + 1) * self.gap, prompt_len=pick(i))
                for i in range(self.n)]


@dataclasses.dataclass(frozen=True)
class TraceArrivals(ArrivalSource):
    """Replay a JSONL trace: one ``{"time": cycles, "prompt_len": n}``
    object per line (blank lines and ``#`` comments skipped), times
    non-decreasing.  Use :func:`write_trace` to produce one from any
    source."""

    path: str

    def _generate(self) -> "list[Arrival]":
        out: "list[Arrival]" = []
        with open(self.path) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                try:
                    rec = json.loads(line)
                    out.append(Arrival(time=float(rec["time"]),
                                       prompt_len=int(rec["prompt_len"])))
                except (KeyError, TypeError, ValueError) as e:
                    raise ValueError(
                        f"{self.path}:{lineno}: bad trace record "
                        f"{line[:60]!r}: {e}") from None
        if not out:
            raise ValueError(f"{self.path}: empty arrival trace")
        return out


def from_records(records: "Iterable[dict]") -> "tuple[Arrival, ...]":
    """Arrivals from in-memory trace records (the JSONL schema)."""
    return tuple(Arrival(time=float(r["time"]),
                         prompt_len=int(r["prompt_len"])) for r in records)


def write_trace(path: str, arrivals: "Iterable[Arrival]") -> int:
    """Serialise arrivals to a JSONL trace readable by
    :class:`TraceArrivals`; returns the number of records written."""
    n = 0
    with open(path, "w") as f:
        for a in arrivals:
            f.write(json.dumps({"time": a.time,
                                "prompt_len": a.prompt_len}) + "\n")
            n += 1
    return n
