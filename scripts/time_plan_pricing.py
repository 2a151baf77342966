#!/usr/bin/env python
"""Time the port's pricing of ``chip_smoke.py``'s planning traffics.

    PYTHONPATH=src python scripts/time_plan_pricing.py [--traffic serve]

For each (backend, units, policy) of ``chip_smoke.PLAN_CASES``, a
planning-only ``ServingEngine(cfg, None)`` on yi-6b at full width and
depth prices the traffic as phase ``plan`` does (``evaluate_schedule``,
then ``price_steps``), and one JSON line reports the host seconds of
each call and the graph's cycles.  ``--traffic`` picks the launcher's
prompts (``launcher``), the serve phase's (``serve``) or both (the
default).  Pure host Python: it needs no card, and its seconds say what
each case would add to ``chip_smoke.py``'s time on the same host.  The
cycles are simulated cycles of the paper's CPU matrix unit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke                                  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--traffic", choices=("launcher", "serve", "both"),
                    default="both")
    args = ap.parse_args(argv)
    from repro_torch.configs.registry import get_config
    from repro_torch.serving.scheduler import price_steps
    cfg = get_config(smoke.ARCH)
    traffics = {"launcher": smoke.PLAN_PROMPTS,
                "serve": smoke.serve_prompts()}
    if args.traffic != "both":
        traffics = {args.traffic: traffics[args.traffic]}
    total = {}
    for traffic, prompts in traffics.items():
        eng = smoke.plan_engine(cfg, prompts)
        total[traffic] = 0.0
        for name, units, policy in smoke.PLAN_CASES:
            t0 = time.perf_counter()
            sched, res = eng.evaluate_schedule(
                name, max_new_tokens=smoke.MAX_NEW, units=units,
                policy=policy, workload=False)
            t1 = time.perf_counter()
            price_steps(sched, name)
            t2 = time.perf_counter()
            total[traffic] += t2 - t0
            print(json.dumps({
                "traffic": traffic, "prompts": list(prompts),
                "backend": name, "units": units, "policy": policy,
                "chosen": sched.policy, "graph_cycles": res.cycles,
                "evaluate_schedule_s": t1 - t0, "price_steps_s": t2 - t1,
                "in_smoke": (name, units, policy) in (
                    smoke.PLAN_CASES if traffic == "launcher"
                    else smoke.PLAN_SERVE_CASES)}), flush=True)
    print(json.dumps({"host_s_by_traffic": total}), flush=True)


if __name__ == "__main__":
    main()
