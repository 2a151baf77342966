"""The canonical Llama-style decode regime the tuner targets.

One deterministic serving queue — the yi-6b reduced config (a
Llama-style GQA decoder), six requests with 64 + 32·i-token prompts,
batch width 2 — planned with the decode-priority policy so the drain is
dominated by skinny-M decode steps.  This mirrors the serving bench
queue in ``benchmarks/run.py`` byte for byte so the tuned speedups the
cache records price exactly the workload the tracked benches report;
it is re-declared here because the package must not import from the
``benchmarks/`` harness.  The reference draws the prompts' tokens with
``jax.random``, which torch cannot reproduce; a planning-only engine
reads only their lengths, so this copy draws them from a seeded
``torch.Generator`` and plans the identical schedule.

:func:`measure_decode_regime` prices the four (tuned × fused) corners of
one platform on the cluster DES and isolates the epilogue-fusion
contribution — the paper attributes >30% of its end-to-end serving win
to fusion, and this is where that claim is measured rather than assumed.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.hardware import PLATFORMS
from repro_torch.tune.space import (DEFAULT_CONFIG, TunedConfig,
                                    schedule_bucket)

#: the queue — identical to ``benchmarks/run.py serving_queue``.
N_REQUESTS = 6
MAX_BATCH = 2
CACHE_LEN = 256
MODEL = "yi-6b"

#: the plan — the decode-heavy drain of that queue on a 2-unit cluster.
UNITS = 2
MAX_NEW_TOKENS = 16
POLICY = "decode-priority"


def decode_regime_engine():
    """(cfg, engine) with the canonical queue submitted."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config(MODEL, reduced=True)
    eng = ServingEngine(cfg, params=None, max_batch=MAX_BATCH,
                        cache_len=CACHE_LEN)
    gen = torch.Generator().manual_seed(0)
    for i in range(N_REQUESTS):
        eng.submit(torch.randint(0, cfg.vocab_size, (64 + 32 * i,),
                                 generator=gen))
    return cfg, eng


def decode_regime_schedule(units: int = UNITS,
                           max_new_tokens: int = MAX_NEW_TOKENS,
                           policy: str = POLICY):
    """(cfg, BatchSchedule) for the canonical decode-heavy drain."""
    cfg, eng = decode_regime_engine()
    sched = eng.plan(max_new_tokens=max_new_tokens, units=units,
                     policy=policy)
    return cfg, sched


def measure_decode_regime(platform_name: str,
                          tuned: "TunedConfig | None" = None,
                          units: int = UNITS) -> "dict[str, float]":
    """Cluster-DES makespans of the four (tuned × fused) corners on one
    platform, plus the derived speedups:

    * ``speedup``        — untuned-unfused / tuned-fused, the pinned
      end-to-end win the BENCH rows record;
    * ``tuned_speedup``  — untuned default (fused) / tuned, the tuning
      dispatch win in isolation;
    * ``fusion_speedup`` — tuned-unfused / tuned, the epilogue-fusion
      contribution with every other tuned knob held fixed.

    ``tuned=None`` resolves the platform's cached winner for the
    schedule's bucket (falling back to the untuned default).
    """
    from repro_torch.tune.autotune import measure_schedule
    from repro_torch.tune.cache import lookup

    platform = PLATFORMS[platform_name]
    _, sched = decode_regime_schedule(units=units)
    if tuned is None:
        tuned = lookup(platform_name, schedule_bucket(sched)) or DEFAULT_CONFIG
    corners = {
        "tuned": tuned,
        "tuned_unfused": dataclasses.replace(tuned, fused=False),
        "untuned": DEFAULT_CONFIG,
        "untuned_unfused": dataclasses.replace(DEFAULT_CONFIG, fused=False),
    }
    out = {name: measure_schedule(sched, cfg, platform)
           for name, cfg in corners.items()}
    out["speedup"] = out["untuned_unfused"] / out["tuned"]
    out["tuned_speedup"] = out["untuned"] / out["tuned"]
    out["fusion_speedup"] = out["tuned_unfused"] / out["tuned"]
    return out
