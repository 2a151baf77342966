"""Serving-scheduler policies, priced before they ever run.

The PyTorch port's counterpart of ``serving_policies.py``.  Compares the
three registered batching policies (``full-prefill``,
``chunked-prefill``, ``decode-priority``) on one queue, in simulated
cycles of the paper's CPU matrix unit:

* decode first-token p50/p99 + inter-token latency from the analytical
  closed form (no DES run), single-unit and on a 2-unit cluster;
* the auto-picked (policy × partition) candidate —
  ``plan(policy="auto")``;
* a heterogeneous topology (4-TOPS + 2-TOPS units) priced through the
  same contention-aware form with ``unit-affinity`` placement;
* a Perfetto trace of the decode-priority schedule on ``desim-cluster``
  with prefill-chunk / decode phase markers (open in
  https://ui.perfetto.dev).

    PYTHONPATH=src python examples/serving_policies_torch.py [--device cpu]

Pricing runs on the host; the prompts are drawn on the CUDA card, or on
the CPU with ``--device cpu``, and without a card and without
``--device`` it stops with an error.  The two traces are written into
the working directory.
"""

import argparse
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch import backend
from repro_torch.configs.registry import get_config
from repro_torch.launch.serve import resolve_device
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import available_policies, schedule_metrics


def queue(cfg, n_requests=6, arrival_gap=0.0, prompts=None, device="cpu"):
    """A planning-only engine (no weights) holding ``n_requests`` prompts
    of 48 + 24 i tokens, drawn from a seeded generator on ``device``
    unless ``prompts`` gives them."""
    eng = ServingEngine(cfg, params=None, max_batch=2, cache_len=256)
    if prompts is None:
        gen = torch.Generator(device=device).manual_seed(0)
        prompts = [torch.randint(0, cfg.vocab_size, (48 + 24 * i,),
                                 generator=gen, device=device)
                   for i in range(n_requests)]
    for i, p in enumerate(prompts):
        eng.submit(p, arrival_time=i * arrival_gap)
    return eng


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, required)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config("yi-6b", reduced=True)
    eng = queue(cfg, device=device)
    found = {}

    print("== policies on the analytical closed form ==")
    for units in (1, 2):
        for pol in available_policies():
            sched = eng.plan(max_new_tokens=16, units=units, policy=pol)
            m = schedule_metrics(sched, cfg.n_layers, "analytical")
            found[f"u{units} {pol}"] = m
            print(f"  u{units} {pol:16s} decode_p50={m['decode_p50']:9.0f} "
                  f"p99={m['decode_p99']:9.0f} itl={m['itl_p50']:6.0f} "
                  f"makespan={m['makespan']:9.0f} cyc")

    sched, report = eng.autoplan(max_new_tokens=16, units=2)
    chosen = report["chosen"]
    found["auto"] = chosen
    print(f"auto -> {chosen['candidate']} "
          f"(decode_p50={chosen['decode_p50']:.0f}, "
          f"makespan={chosen['makespan']:.0f})")

    print("== heterogeneous cluster (4-TOPS + 2-TOPS) ==")
    from repro_torch.core.config import CASE_STUDY, PLATFORM_2TOPS
    from repro_torch.sim import ClusterTopology, UnitSpec
    fast = CASE_STUDY.with_(freq_hz=PLATFORM_2TOPS.freq_hz)
    topo = ClusterTopology(
        unit_specs=(UnitSpec(unit=fast), UnitSpec(unit=PLATFORM_2TOPS)),
        platform=None)
    print("  topology:", topo.describe())
    sched = eng.plan(max_new_tokens=16, units=2, policy="decode-priority")
    ana = backend.get("analytical", topology=topo,
                      strategy="unit-affinity",
                      affinity=dict(sched.affinity))
    w = ana.run_workload(sched.layers)
    found["heterogeneous"] = w
    print(f"  decode-priority on het topo: {w['cycles']:.0f} cyc, "
          f"agg util {w['matrix_utilization']:.1%}, "
          f"loader util {w['loader_utilization']:.1%}")

    print("== Perfetto trace with policy phase markers ==")
    from repro_torch.sim.trace import dump_chrome_trace
    dc = backend.get("desim-cluster", units=2, strategy="output-tile")
    graph = dc.lower(sched.layers[:6])        # first scheduling rounds
    res = dc.run_graph(graph)
    found["trace"] = res.cycles
    path = dump_chrome_trace(res.timeline, "serving_policy_trace.json")
    print(f"  wrote {path} (slices carry args.phase = "
          "prefill-chunk / decode)")

    print("== cross-step overlap: relaxed vs chained lowering ==")
    # relaxed keeps only true per-request hazards, so decode (pinned to
    # unit 0 by the policy's affinity hints) runs beside hazard-free
    # prefill chunks on unit 1 — same GEMMs, lower makespan.
    for ov in ("chained", "relaxed"):
        sched, res = eng.evaluate_schedule(
            "desim-cluster", max_new_tokens=16, units=2,
            policy="decode-priority", overlap=ov, workload=False)
        found[ov] = (res.cycles, res.utilization)
        print(f"  {ov:8s} DES makespan {res.cycles:10.0f} cyc "
              f"(agg util {res.utilization:.1%})")
        if ov == "relaxed":
            path = dump_chrome_trace(res.timeline,
                                     "serving_overlap_trace.json")
            print(f"  wrote {path} — decode slices on unit 0 overlap "
                  "prefill on unit 1 in Perfetto")

    print("== arrival times: TTFT under load ==")
    # requests trickling in every 30k cycles instead of all at t=0:
    # release times hold steps until their requests exist, and TTFT is
    # measured from each request's own arrival.
    late = queue(cfg, arrival_gap=30000.0, device=device)
    for label, e in (("all at t=0", eng), ("30k-cycle gaps", late)):
        m = schedule_metrics(e.plan(max_new_tokens=16,
                                    policy="decode-priority"),
                             cfg.n_layers, "analytical")
        found[label] = m
        print(f"  {label:15s} ttft_p50={m['ttft_p50']:9.0f} "
              f"ttft_p99={m['ttft_p99']:9.0f} "
              f"makespan={m['makespan']:9.0f} cyc")
    return found


if __name__ == "__main__":
    main()
