#!/usr/bin/env python
"""Record the reference's numbers that ``chip_smoke.py``'s ``plan`` and
``online`` phases hold the port to.

    PYTHONPATH=src python scripts/record_smoke_constants.py

Runs the JAX package (``repro``) on the CPU at the smoke phases' own
arguments — yi-6b at full width and depth, the two planning traffics
and the online phase's seeded arrivals — and prints one object:

* ``plan``: for each (backend, policy) of ``chip_smoke.PLAN_CASES``, the
  chosen policy, the priced graph's cycles, ``price_steps``'s per-step
  cycles and ``decode_latency_stats`` of a planning-only
  ``ServingEngine(cfg, None)`` holding the launcher's prompts
  (``chip_smoke.PLAN_PROMPTS``), requests arriving every
  ``chip_smoke.PLAN_ARRIVAL_GAP`` cycles;
* ``plan_serve``: the same for each case of
  ``chip_smoke.PLAN_SERVE_CASES`` on the serve traffic's prompts
  (``chip_smoke.serve_prompts()``);
* ``online``: ``OnlineResult.summary()``, the paged KV cache's counters
  and trace digest and the span log's digest of the ``online`` phase's
  closed loop;
* ``launcher``: the ``[plan:…]`` / ``[online:…]`` lines and summary
  tables of the reference launcher at the smoke phases' arguments (its
  weights are not built: only the planning half runs), wall-clock
  seconds cut out.

Every number is deterministic Python (the DES and the analytical closed
form, seeded ``random.Random``): simulated cycles of the paper's CPU
matrix unit, not times of any device.  The script reads its arguments
from ``chip_smoke.py``, so the two cannot drift apart, and prints the
assignment of ``chip_smoke.REFERENCE``, to paste over the old one.
"""

from __future__ import annotations

import contextlib
import io
import pprint
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke                                  # noqa: E402

PREFIX = "REFERENCE = "


def plan_constants(cfg, prompts, cases) -> dict:
    import jax.numpy as jnp
    from repro.serving.engine import ServingEngine
    from repro.serving.scheduler import decode_latency_stats, price_steps
    eng = ServingEngine(cfg, None, max_batch=smoke.MAX_BATCH)
    for i, n in enumerate(prompts):
        eng.submit(jnp.zeros(n, jnp.int32),
                   arrival_time=i * smoke.PLAN_ARRIVAL_GAP)
    out = {}
    for backend_name, units, policy in cases:
        sched, res = eng.evaluate_schedule(
            backend_name, max_new_tokens=smoke.MAX_NEW, units=units,
            policy=policy, workload=False)
        steps = price_steps(sched, backend_name)
        out[f"{backend_name}/{policy}"] = {
            "policy": sched.policy, "units": sched.units,
            "steps": len(sched.steps), "graph_cycles": res.cycles,
            "step_cycles": steps,
            "stats": decode_latency_stats(sched, steps, cfg.n_layers)}
    return out


def online_constants(cfg) -> dict:
    from repro.serving.arrivals import PoissonArrivals, qps_to_gap
    from repro.serving.online import OnlineServingEngine
    eng = OnlineServingEngine(cfg, **smoke.ONLINE_ENGINE)
    res = eng.run(PoissonArrivals(
        mean_gap=qps_to_gap(smoke.ONLINE_QPS, eng.freq_hz),
        n=smoke.ONLINE_REQUESTS, seed=0))
    return {"summary": res.summary(), "kv": eng.kv_cache.counters,
            "kv_digest": eng.kv_cache.trace_digest(),
            "span_digest": smoke.span_digest(res.span_log),
            "span_violations": res.span_log.validate()}


def launcher_lines(argv) -> "tuple[str, ...]":
    """The reference launcher's output at ``argv``, its weights and its
    serving run stubbed out (the plan and online lines need neither)."""
    from repro.launch import serve
    from repro.serving.engine import ServingEngine

    class NoWeights:
        @staticmethod
        def init(cfg, key):
            return None
    buf = io.StringIO()
    with mock.patch.object(serve, "family_module",
                           lambda cfg: NoWeights), \
            mock.patch.object(ServingEngine, "run",
                              lambda self, **kw: []), \
            contextlib.redirect_stdout(buf):
        serve.main(argv)
    return smoke.launcher_text(buf.getvalue())


def main() -> None:
    from repro.configs.registry import get_config
    cfg = get_config(smoke.ARCH)
    text = pprint.pformat({
        "plan": plan_constants(cfg, smoke.PLAN_PROMPTS, smoke.PLAN_CASES),
        "plan_serve": plan_constants(cfg, smoke.serve_prompts(),
                                     smoke.PLAN_SERVE_CASES),
        "online": online_constants(cfg),
        "launcher": {"plan": launcher_lines(smoke.PLAN_LAUNCH_ARGV),
                     "online": launcher_lines(smoke.ONLINE_LAUNCH_ARGV)}},
        width=79 - len(PREFIX))
    print(PREFIX + text.replace("\n", "\n" + " " * len(PREFIX)))


if __name__ == "__main__":
    main()
