"""Batched serving engine on the async programming model (execution half).

Every projection is a ``cute_matmul`` with fused epilogue, routed through
the ``repro_torch.backend`` default (the CUDA kernel unless
``set_default_matmul_backend`` says otherwise), and prefill attention
goes through the flash kernel when ``cfg.backend == "kernel"``.

``generate`` is the synchronous core: prefill the prompt batch, then a
Python decode loop (the reference's ``lax.scan``) with greedy or
temperature sampling.  ``_step_layer`` is one serving step as the
``LayerTrace`` the TaskGraph lowering takes.  The reference's planning
half (``plan``, ``evaluate_schedule``, ``BatchSchedule``, metrics) is
not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
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
    """One queued serving request.  ``arrival_time`` is kept for the
    planning half, which prices schedules against it."""

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


class ServingEngine:
    """Continuous-batching façade: queue requests, drain them in padded
    batches.  ``results`` holds the last ``run``'s per-batch
    :class:`GenerateResult` (tokens, logits, timing marks)."""

    def __init__(self, cfg: ArchConfig, params, max_batch: int = 8,
                 cache_len: int = 512):
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.device = params["embedding"].device
        self._queue: "list[torch.Tensor]" = []   # submission order
        self._arrivals: "list[float]" = []
        self.results: "list[GenerateResult]" = []

    def submit(self, tokens, arrival_time: float = 0.0) -> int:
        """Queue a request; returns a request id (asyncMatMul-style).

        ``tokens`` is a prompt token array or a :class:`Request`.
        Requests must be submitted in non-decreasing arrival order."""
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

    def run(self, max_new_tokens: int = 32, temperature: float = 0.0,
            generator: Optional[torch.Generator] = None):
        """Drain the queue in left-padded batches; returns one token
        tensor per request."""
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
