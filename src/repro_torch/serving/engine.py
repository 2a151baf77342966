"""Batched serving engine on the async programming model.

The paper's asyncMatMul/checkMatmul contract shows up twice here:

* per step — every projection is a ``cute_matmul`` with fused epilogue,
  routed through the ``repro_torch.backend`` default (the CUDA kernel
  unless ``set_default_matmul_backend`` says otherwise), and prefill
  attention goes through the flash kernel when ``cfg.backend ==
  "kernel"``;
* across *schedules* — ``ServingEngine.plan`` lowers the pending queue
  into a continuous-batching prefill/decode :class:`BatchSchedule` whose
  ``LayerTrace`` steps feed ``sim.lower.workload_to_graph``, so a
  batching policy can be priced on the ``desim`` backend's per-resource
  timelines (in simulated cycles of the paper's CPU matrix unit) and
  the identical schedule graph executed bit-exactly through K1 before
  it ever serves.

``generate`` is the synchronous core: prefill the prompt batch, then a
Python decode loop (the reference's ``lax.scan``) with greedy or
temperature sampling.  The planning half is a copy of the reference's;
``ServingEngine(cfg, None)`` plans without weights and cannot ``run``.
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Optional

import torch

from repro_torch.core.precision import DataType
from repro_torch.core.simulator import VECTOR_OP_INSTRS, LayerTrace
from repro_torch.core.task import MatMulTask
from repro_torch.models.base import ArchConfig, family_module


def _mark(device: torch.device):
    """A point in time on ``device``'s clock: a CUDA event recorded on the
    current stream, or the host clock on the CPU."""
    if device.type == "cuda":
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event
    return time.perf_counter()


def _elapsed_ms(start, end) -> float:
    if isinstance(start, float):
        return (end - start) * 1e3
    end.synchronize()
    return start.elapsed_time(end)


@dataclasses.dataclass
class GenerateResult:
    tokens: torch.Tensor          # (B, n_new)
    logits_last: torch.Tensor     # (B, V)
    steps: int
    marks: tuple = ()             # (start, prefill done, decode done)

    def prefill_ms(self) -> float:
        """Cache allocation, prefill and the first sample."""
        return _elapsed_ms(self.marks[0], self.marks[1])

    def decode_step_ms(self) -> float:
        """Mean time of one decode step (nan without decode steps)."""
        n = self.steps - 1
        return _elapsed_ms(self.marks[1], self.marks[2]) / n if n else \
            float("nan")


@dataclasses.dataclass(frozen=True)
class Request:
    """One queued serving request.

    ``arrival_time`` is the cycle (simulated-machine clock, the same
    currency every backend prices in) at which the request becomes
    available.  It flows ``submit`` → ``PolicyContext.arrival_times`` →
    per-step ``BatchSchedule.release_times`` → ``Node.release_time``,
    so the DES refuses to start a step before its requests exist and
    ``decode_latency_stats`` reports TTFT against the arrival instead of
    the t = 0 lower bound.  The default 0.0 reproduces the classic
    everything-queued-at-plan-time behaviour exactly.
    """

    tokens: torch.Tensor
    arrival_time: float = 0.0


def make_prefill(cfg: ArchConfig):
    mod = family_module(cfg)

    def prefill_step(params, batch, cache):
        return mod.prefill(cfg, params, batch, cache)
    return prefill_step


def make_decode(cfg: ArchConfig):
    mod = family_module(cfg)

    def decode_step(params, tokens, cache, pos):
        return mod.decode_step(cfg, params, tokens, cache, pos)
    return decode_step


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
           temperature: float = 0.0) -> torch.Tensor:
    """Greedy argmax, or a draw from softmax(logits / temperature)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).squeeze(-1)


def generate(cfg: ArchConfig, params, batch, *, max_new_tokens: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             cache_len: Optional[int] = None) -> GenerateResult:
    """Prefill + decode loop.  batch["tokens"]: (B, S_prompt)."""
    mod = family_module(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    cache_len = cache_len or (s + max_new_tokens)
    start = _mark(tokens.device)

    cache = mod.init_cache(cfg, b, cache_len, device=tokens.device)
    logits, cache = mod.prefill(cfg, params, batch, cache)
    tok = sample(logits, generator, temperature)
    prefilled = _mark(tokens.device)

    out = [tok]
    for pos in range(s, s + max_new_tokens - 1):
        logits, cache = mod.decode_step(cfg, params, tok[:, None], cache, pos)
        tok = sample(logits, generator, temperature)
        out.append(tok)
    return GenerateResult(tokens=torch.stack(out, dim=1), logits_last=logits,
                          steps=max_new_tokens,
                          marks=(start, prefilled, _mark(tokens.device)))


# ---------------------------------------------------------------------------
# Batch schedules: the serving queue as a TaskGraph workload.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BatchStep:
    """One continuous-batching step: a padded batch through the model.

    ``kind`` is ``"prefill"``, ``"decode"``, or ``"mixed"`` (a chunked-
    prefill step with decode iterations piggybacked onto the chunk).
    ``decode_requests`` names the subset of ``requests`` that receives a
    decode token from this step — empty for pure prefill, and left empty
    by the classic full-prefill lowering (whose pure decode steps imply
    ``decode_requests == requests``).
    """

    kind: str                    # "prefill" | "decode" | "mixed"
    requests: "tuple[int, ...]"  # request ids riding this batch
    tokens: int                  # rows M entering each projection GEMM
    repeat: int                  # model layers (× decode steps for decode)
    decode_requests: "tuple[int, ...]" = ()


@dataclasses.dataclass
class BatchSchedule:
    """A planned drain of the queue, in the simulator's vocabulary.

    ``layers`` carries one :class:`~repro_torch.core.simulator.LayerTrace` per
    step (a representative transformer layer's projection GEMMs + vector
    work; ``repeat`` scales it to full depth), ready for
    ``sim.lower.workload_to_graph`` / any ``repro_torch.backend`` engine.

    ``units`` records the cluster width the schedule is planned against:
    a cluster backend (``desim-cluster``, or ``analytical`` at
    ``units=N``) shards every
    step's GEMMs across that many matrix units, so the same schedule is
    priced on contended multi-unit timelines.

    ``policy`` names the :mod:`repro_torch.serving.scheduler` batching policy
    that produced the schedule; ``affinity`` carries that policy's
    per-step unit hints (``{step layer name: unit}``) for the
    ``unit-affinity`` partition strategy, and ``strategy`` records the
    partition strategy ``plan(policy="auto")`` priced the schedule
    against (``None``: caller's choice).

    ``overlap`` selects how the steps lower into one TaskGraph
    (``sim.lower.workload_to_graph``): ``"chained"`` serialises every
    step behind the previous one (the classic over-approximation);
    ``"relaxed"`` keeps only the true per-request data hazards
    (:meth:`step_deps`), so steps placed on disjoint units genuinely run
    concurrently.  ``arrival_times`` (per request id, cycles) and
    ``release_times`` (per step — the max arrival over the step's
    requests) carry request-arrival semantics into the graph as node
    release times and into ``decode_latency_stats`` as the TTFT
    baseline.

    ``refill_bytes`` (per step) carries the paged KV-cache refill each
    step owes — stamped by :meth:`repro_torch.serving.scheduler
    .SchedulingPolicy._finish` from the context's residency state and
    lowered by ``workload_to_graph`` into a ``memory`` node ahead of
    the step's tiles, so the DES and the analytical form both price
    evicted-block refills while execution (which skips memory nodes)
    stays bit-exact.  Empty means no tracked KV pressure.
    """

    steps: "list[BatchStep]"
    layers: "list[LayerTrace]"
    units: int = 1
    policy: str = "full-prefill"
    affinity: "dict[str, int]" = dataclasses.field(default_factory=dict)
    strategy: "Optional[str]" = None
    overlap: str = "chained"
    arrival_times: "tuple[float, ...]" = ()
    release_times: "tuple[float, ...]" = ()
    refill_bytes: "tuple[float, ...]" = ()

    def step_deps(self) -> "list[tuple[int, ...]]":
        """True cross-step data hazards: step *j* depends on step *i*
        iff *i* is the most recent earlier step touching one of *j*'s
        requests — the per-request KV-cache/activation chain (a decode
        iteration reads the KV its own prefill and earlier decode steps
        wrote; steps over disjoint requests share no state).  This is
        the dependency set ``overlap="relaxed"`` lowers, replacing the
        coarse chain with edges that cannot change results."""
        last: "dict[int, int]" = {}
        deps: "list[tuple[int, ...]]" = []
        for j, step in enumerate(self.steps):
            dj = sorted({last[r] for r in step.requests if r in last})
            deps.append(tuple(dj))
            for r in step.requests:
                last[r] = j
        return deps

    def arrival_of(self, request: int) -> float:
        """Arrival cycle of a request id (0.0 when arrivals untracked)."""
        return (self.arrival_times[request]
                if request < len(self.arrival_times) else 0.0)

    def gemm_tasks(self) -> "dict[str, MatMulTask]":
        """``{graph GEMM label: task}`` — the labels
        ``workload_to_graph`` assigns, keyed for ``run_graph`` operands."""
        return {f"{lt.name}/g{i}": g
                for lt in self.layers for i, g in enumerate(lt.gemms)}

    def example_operands(self, seed: int = 0, device=None, low: int = -8,
                         high: int = 8) -> "dict[str, tuple]":
        """Random int8 ``(a, b)`` tensors for every GEMM of the schedule —
        lets an executing backend run the identical schedule graph for
        real (the parity suite checks that desim and desim-cluster agree
        bit-exactly).

        Each GEMM's operands come from a ``torch.Generator`` on
        ``device`` seeded with ``zlib.crc32(f"{seed}/{label}")``, so they
        depend only on the seed, the label and the device type: two
        schedules sharing a label (or one schedule re-planned with more
        steps) get identical tensors.  Values lie in ``[low, high)``.
        """
        device = torch.device("cpu" if device is None else device)
        ops = {}
        for label, t in self.gemm_tasks().items():
            gen = torch.Generator(device=device).manual_seed(
                zlib.crc32(f"{seed}/{label}".encode()))
            ops[label] = (
                torch.randint(low, high, (t.m, t.k), generator=gen,
                              dtype=torch.int8, device=device),
                torch.randint(low, high, (t.k, t.n), generator=gen,
                              dtype=torch.int8, device=device))
        return ops


def _step_layer(cfg: ArchConfig, name: str, tokens: int,
                repeat: int) -> LayerTrace:
    """One serving step as a fused region: the four projection GEMMs of a
    representative transformer layer (int8, the paper's W8A8 pipeline)
    plus first-order vector work (norms, dequant, activation, residual)."""
    d = cfg.d_model
    mlp_n = cfg.d_ff * (2 if cfg.mlp_glu else 1)
    gemms = (
        MatMulTask(m=tokens, n=cfg.q_dim + 2 * cfg.kv_dim, k=d,
                   data_type=DataType.INT8),
        MatMulTask(m=tokens, n=d, k=cfg.q_dim, data_type=DataType.INT8),
        MatMulTask(m=tokens, n=mlp_n, k=d, data_type=DataType.INT8),
        MatMulTask(m=tokens, n=d, k=cfg.d_ff, data_type=DataType.INT8),
    )
    act = (cfg.mlp_activation if cfg.mlp_activation in VECTOR_OP_INSTRS
           else "eltwise_misc")
    vector_ops = {
        "rmsnorm": 2.0 * tokens * d,
        "dequant": float(sum(t.m * t.n for t in gemms)),
        act: float(tokens * cfg.d_ff),
        "residual": 2.0 * tokens * d,
    }
    if cfg.mlp_glu:
        vector_ops["glu_mul"] = float(tokens * cfg.d_ff)
    return LayerTrace(name, gemms, vector_ops=vector_ops,
                      intermediate_bytes=4.0 * tokens * mlp_n,
                      repeat=repeat)


def _refuse_tuned(tuned: bool) -> None:
    if tuned:
        raise NotImplementedError(
            "tuned=True needs the reference's tuning package (tune/*: "
            "the autotuner, its cache and the registry's tuned dispatch), "
            "which is not ported yet (ROADMAP.md, queue 1)")


class ServingEngine:
    """Continuous-batching façade with async prefill dispatch: queue
    requests, plan and price their drain, drain them in padded batches.
    ``results`` holds the last ``run``'s per-batch
    :class:`GenerateResult` (tokens, logits, timing marks).

    ``params=None`` builds a planning-only engine: its queue holds the
    prompts as CPU tensors (only their lengths are read), it plans and
    prices schedules, and its ``run`` raises.

    ``metrics`` is the :class:`~repro_torch.obs.metrics.MetricsRegistry`
    the engine reports into — by default the process registry, which
    starts *disabled* so planning/pricing pay nothing; ``launch/serve.py
    --metrics-out`` enables it.
    """

    def __init__(self, cfg: ArchConfig, params, max_batch: int = 8,
                 cache_len: int = 512, metrics=None):
        from repro_torch.obs import default_registry
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.metrics = metrics if metrics is not None else default_registry()
        self.device = (torch.device("cpu") if params is None
                       else params["embedding"].device)
        self._queue: "list[torch.Tensor]" = []   # submission order
        self._arrivals: "list[float]" = []       # per-request arrival cycles
        self.results: "list[GenerateResult]" = []

    def submit(self, tokens, arrival_time: float = 0.0) -> int:
        """Queue a request; returns a request id (asyncMatMul-style).

        ``tokens`` is a prompt token array or a :class:`Request`.
        ``arrival_time`` (cycles) is when the request becomes available:
        schedules planned from this queue stamp it on their steps as
        release times, so pricing reports genuine time-to-first-token
        under load rather than the all-arrived-at-t=0 lower bound.
        Requests must be submitted in non-decreasing arrival order (the
        queue *is* the arrival order)."""
        if isinstance(tokens, Request):
            tokens, arrival_time = tokens.tokens, tokens.arrival_time
        if arrival_time < 0:
            raise ValueError(f"arrival_time must be >= 0, "
                             f"got {arrival_time}")
        if self._arrivals and arrival_time < self._arrivals[-1]:
            raise ValueError(
                f"arrival_time {arrival_time} precedes the previous "
                f"request's {self._arrivals[-1]}; submit in arrival order")
        self._queue.append(torch.as_tensor(tokens, device=self.device))
        self._arrivals.append(float(arrival_time))
        return len(self._queue) - 1

    @property
    def requests(self) -> "list[Request]":
        """The pending queue as :class:`Request` records."""
        return [Request(t, a) for t, a in zip(self._queue, self._arrivals)]

    # ----- batch schedules -> backends -----------------------------------
    def _policy_context(self, max_new_tokens: int, units: int):
        from repro_torch.serving.scheduler import PolicyContext
        return PolicyContext(
            cfg=self.cfg,
            prompt_lengths=tuple(int(t.shape[-1]) for t in self._queue),
            max_batch=self.max_batch, max_new_tokens=max_new_tokens,
            units=units,
            arrival_times=(tuple(self._arrivals)
                           if any(self._arrivals) else ()))

    def plan(self, max_new_tokens: int = 32, units: int = 1,
             policy: str = "full-prefill", overlap: str = "chained",
             tuned: bool = False, **policy_kw) -> BatchSchedule:
        """Plan the continuous-batching drain of the current queue
        (non-destructive) under a :mod:`repro_torch.serving.scheduler` batching
        policy.  The default ``full-prefill`` reproduces the classic
        inline policy bit-identically: per padded chunk, one prefill step
        over ``B × S_padded`` tokens, then ``max_new_tokens`` decode
        steps of ``B`` tokens (collapsed into one repeated LayerTrace).
        ``chunked-prefill`` / ``decode-priority`` interleave prefill
        chunks with in-flight decode; ``policy="auto"`` prices every
        (policy × partition × overlap) candidate with the
        contention-aware ``analytical`` closed form and returns the best
        one.

        ``units`` is the cluster width the schedule targets — recorded on
        the schedule and consumed by ``evaluate_schedule`` so a cluster
        backend prices the drain on ``units`` contended matrix units.
        ``overlap`` selects the step-chaining mode the schedule lowers
        with (``"chained"`` serial / ``"relaxed"`` true data hazards
        only — see :class:`BatchSchedule`); ignored by ``policy="auto"``
        which sweeps both.

        ``tuned=True`` (the reference's per-platform tuning cache)
        raises ``NotImplementedError``: the tuning package is not ported
        yet, and an untuned plan is not passed off as a tuned one."""
        from repro_torch.serving import scheduler
        from repro_torch.sim.lower import OVERLAP_MODES
        _refuse_tuned(tuned)
        if overlap not in OVERLAP_MODES:
            raise ValueError(f"unknown overlap mode {overlap!r}; one of "
                             f"{OVERLAP_MODES}")
        ctx = self._policy_context(max_new_tokens, units)
        if policy == "auto":
            # policy kwargs (chunk_tokens, ...) sweep the candidates;
            # select_schedule's own knobs pass through by name.
            select = {"backend_name", "objective", "makespan_slack",
                      "policies", "strategies", "overlaps", "policy_kw"}
            kw = {k: v for k, v in policy_kw.items() if k in select}
            extra = {k: v for k, v in policy_kw.items()
                     if k not in select}
            if extra:
                kw["policy_kw"] = {**extra, **kw.get("policy_kw", {})}
            sched, _ = scheduler.select_schedule(ctx, **kw)
        else:
            pol = scheduler.get_policy(policy, **policy_kw)
            sched = pol.schedule(ctx)
            if not getattr(pol, "meta", False):
                # meta-policies (auto-slo) sweep overlap themselves; the
                # caller's default must not clobber their choice.
                sched.overlap = overlap
        self._record_plan(sched)
        return sched

    def _record_plan(self, sched) -> None:
        """Planning counters (no-ops while the registry is disabled)."""
        m = self.metrics
        m.counter("serving_plans_total", policy=sched.policy,
                  overlap=sched.overlap, units=sched.units).inc()
        m.counter("serving_requests_total", policy=sched.policy).inc(
            len({r for s in sched.steps for r in s.requests}))
        m.counter("serving_steps_total", policy=sched.policy).inc(
            len(sched.steps))

    def autoplan(self, max_new_tokens: int = 32, units: int = 1,
                 **select_kw) -> "tuple[BatchSchedule, dict]":
        """``plan(policy="auto")`` with the full pricing report: every
        (policy × partition) candidate priced by the analytical closed
        form, plus the chosen candidate's metrics under ``"chosen"``."""
        from repro_torch.serving import scheduler
        return scheduler.select_schedule(
            self._policy_context(max_new_tokens, units), **select_kw)

    def evaluate_schedule(self, backend_name: str = "desim",
                          max_new_tokens: int = 32, operands=None,
                          units: Optional[int] = None,
                          policy: str = "full-prefill",
                          overlap: str = "chained",
                          workload: bool = True,
                          tuned: bool = False,
                          **backend_kwargs):
        """Price the planned schedule on a modelling backend.

        Lowers ``plan(max_new_tokens, units, policy, overlap)`` through
        ``workload_to_graph`` at the backend's granularity/fusion policy
        (``overlap="relaxed"`` keeps only true per-request hazards, so
        steps on disjoint units overlap on the priced timeline; arrival
        times become node release times either way)
        and runs the graph — ``desim`` returns the per-resource timeline
        (and, given ``operands``, the executed numbers);
        ``desim-cluster`` with ``units=N`` prices the same schedule on N
        matrix units contending for the shared loader, and
        ``analytical`` with ``units=N`` prices it with the contention-
        aware closed form without running the DES.  Cluster partition
        defaults follow ``scheduler.backend_kwargs_for`` (the caller's
        explicit ``strategy`` wins, else the schedule's auto-chosen one,
        else ``unit-affinity`` when the policy emitted placement hints,
        else ``output-tile`` — serving GEMMs are short and wide), so
        this prices the same deployment ``price_steps`` does.  Returns
        ``(schedule, ExecResult)``; ``result.detail["workload"]``
        carries the repeat-weighted whole-schedule cost dict
        (``workload=False`` skips that second pricing pass — callers
        that also run ``scheduler.price_steps`` already have it as the
        per-step sum).
        """
        units = 1 if units is None else units
        sched = self.plan(max_new_tokens, units=units, policy=policy,
                          overlap=overlap, tuned=tuned)
        return sched, self.run_schedule(
            sched, backend_name=backend_name, operands=operands,
            workload=workload, tuned=tuned, **backend_kwargs)

    def run_schedule(self, sched: BatchSchedule,
                     backend_name: str = "desim", operands=None,
                     workload: bool = True, attach_spans: bool = True,
                     tuned: bool = False, **backend_kwargs):
        """Price an already-planned schedule on a modelling backend —
        the execution half of :meth:`evaluate_schedule`, callable with a
        schedule from any source (the online loop re-plans its own
        epoch schedules and executes each committed one through here,
        so spans/metrics stay grounded in the same DES path).  Returns
        the :class:`~repro_torch.backend.base.ExecResult`; ``attach_spans``
        controls the :class:`~repro_torch.obs.SpanLog` join (the online loop
        assembles its own global log across epochs instead).

        ``tuned=True`` (the reference's tuned backend dispatch) raises
        ``NotImplementedError``, as in :meth:`plan`."""
        from repro_torch import backend
        from repro_torch.serving.scheduler import backend_kwargs_for
        _refuse_tuned(tuned)
        backend_kwargs = backend_kwargs_for(sched, units=sched.units,
                                            **backend_kwargs)
        # the schedule records the partition it was actually priced
        # under, so downstream latency timelines agree with the pricing.
        sched.strategy = backend_kwargs.get("strategy", sched.strategy)
        eng = backend.get(backend_name, **backend_kwargs)
        if not eng.models_time:
            raise ValueError(
                f"backend {backend_name!r} executes but does not model "
                "time; use 'desim' or 'analytical'")
        graph = eng.lower(sched)
        result = eng.run_graph(graph, operands)
        if workload:
            result.detail["workload"] = eng.run_workload(sched.layers)
        spans = result.detail.get("step_spans")
        if attach_spans and spans is not None and sched.steps:
            from repro_torch.obs import SpanLog
            log = SpanLog.from_schedule(sched, spans, self.cfg.n_layers)
            result.detail["span_log"] = log
            self._record_spans(log, sched, backend_name)
        return result

    def _record_spans(self, log, sched, backend_name: str) -> None:
        """Fold a priced run's span log into the metrics registry:
        per-request TTFT, per-request span counts, the run's makespan."""
        m = self.metrics
        if not m.enabled:
            return
        labels = dict(policy=sched.policy, backend=backend_name,
                      units=sched.units, overlap=sched.overlap)
        ttft = m.histogram("serving_ttft_cycles", **labels)
        for r in log.requests():
            try:
                ttft.observe(log.ttft(r))
            except KeyError:
                pass                      # request never decodes
        m.histogram("serving_request_spans", **labels).observe(len(log))
        m.gauge("serving_makespan_cycles", **labels).set(
            max((s.end for s in log.spans), default=0.0))

    def run(self, max_new_tokens: int = 32, temperature: float = 0.0,
            generator: Optional[torch.Generator] = None):
        """Drain the queue in left-padded batches; returns one token
        tensor per request.  A planning-only engine (no weights) raises."""
        if self.params is None:
            raise RuntimeError("this ServingEngine was built without "
                               "weights (params=None): it plans and prices "
                               "schedules but cannot run them")
        out = []
        self.results = []
        while self._queue:
            chunk, self._queue = (self._queue[: self.max_batch],
                                  self._queue[self.max_batch:])
            self._arrivals = self._arrivals[len(chunk):]
            s = max(int(t.shape[-1]) for t in chunk)
            toks = torch.stack([torch.nn.functional.pad(t, (s - t.shape[-1],
                                                            0))
                                for t in chunk])
            batch = {"tokens": toks}
            if self.cfg.vision_prefix:
                batch["vision_embeds"] = torch.zeros(
                    (toks.shape[0], self.cfg.vision_prefix,
                     self.cfg.d_model), device=self.device)
            res = generate(self.cfg, self.params, batch,
                           max_new_tokens=max_new_tokens,
                           temperature=temperature, generator=generator,
                           cache_len=self.cache_len)
            self.results.append(res)
            out.extend(list(res.tokens))
        return out
