"""Serving launcher: batched generation through the port's kernels.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \\
        --reduced --requests 6 --max-new 16

Runs on the CUDA card; ``--device cpu`` runs the kernels' plain versions
on the CPU instead.  Without ``--device`` and without a card it stops
with an error rather than falling back to the CPU, in every mode.

``--plan BACKEND`` prices the queued batch schedule on a modelling
backend from the ``repro_torch.backend`` registry before serving: the
queue is lowered through ``workload_to_graph`` and run on e.g. ``desim``
for a per-resource timeline — evaluate a batching policy
(``--max-batch``, ``--policy``) without serving it.  The plan ends with a
one-screen summary table: TTFT/ITL percentiles, makespan, per-unit
matrix utilization and the request-span audit from the obs subsystem.
Its cycles are simulated cycles of the paper's CPU matrix unit.

``--qps RATE`` / ``--arrival-trace PATH`` run the online closed loop
instead (streaming admission and per-epoch re-planning on the modelling
backends; no weights are built).

``--metrics-out PATH`` switches the process-wide metrics registry on
(it is off by default everywhere else) and writes its snapshot on exit —
JSON, or Prometheus text exposition when PATH ends in ``.prom``.

The ``[plan:…]`` and ``[online:…]`` lines are the reference launcher's
(``repro/launch/serve.py``) at the same arguments, wall-clock seconds
aside: the prompt lengths are the same, ``4 + (i * 3) % 12``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import ALL_ARCHS, get_config
from repro_torch.core.precision import disable_tf32
from repro_torch.models.base import family_module
from repro_torch.serving.engine import ServingEngine


def _table(rows: "list[tuple[str, str]]") -> str:
    w = max(len(k) for k, _ in rows)
    bar = "  " + "-" * (w + 24)
    body = "\n".join(f"  {k:<{w}}  {v}" for k, v in rows)
    return f"{bar}\n{body}\n{bar}"


def _span_audit_row(span_log) -> "tuple[str, str]":
    bad = span_log.validate()
    return ("request spans",
            f"{len(span_log)} across {len(span_log.requests())} requests"
            + ("" if not bad else f"  ({len(bad)} VIOLATIONS)"))


def _online_summary(res, policy: str, slo_cycles) -> str:
    """The closed-loop scoreboard: the plan table's latency rows plus
    the online-only goodput / preemption / eviction counters."""
    s = res.summary(slo_cycles)
    rows = [
        ("policy", policy),
        ("requests (completed)",
         f"{len(res.requests)} ({len(res.completed())})"),
        ("admission epochs", f"{len(res.epochs)}"),
        ("TTFT p50 / p99",
         f"{s['ttft_p50']:.0f} / {s['ttft_p99']:.0f} cyc"),
        ("ITL  p50 / p99",
         f"{s['itl_p50']:.0f} / {s['itl_p99']:.0f} cyc"),
        ("makespan", f"{s['makespan']:.0f} cyc"),
        ("goodput", f"{s['goodput_qps']:.0f} req/s"
         + ("" if slo_cycles is None
            else f" (TTFT p99 SLO {slo_cycles:.0f} cyc)")),
        ("preemptions / evictions",
         f"{res.n_preemptions} / {res.n_evictions}"),
        _span_audit_row(res.span_log),
    ]
    return _table(rows)


def _plan_summary(stats: dict, res, sched, span_log) -> str:
    """The one-screen plan scoreboard: latency percentiles, makespan,
    per-unit matrix utilization, span-chain audit."""
    rows = [
        ("policy / overlap", f"{sched.policy} / {sched.overlap}"),
        ("steps (prefill)",
         f"{len(sched.steps)} "
         f"({sum(s.kind == 'prefill' for s in sched.steps)})"),
        ("TTFT p50 / p99",
         f"{stats['ttft_p50']:.0f} / {stats['ttft_p99']:.0f} cyc"),
        ("ITL  p50 / p99",
         f"{stats['itl_p50']:.0f} / {stats['itl_p99']:.0f} cyc"),
        ("makespan", f"{stats['makespan']:.0f} cyc"),
    ]
    per_unit = {}
    if res.timeline is not None:
        for rname, u in res.timeline.utilizations().items():
            head, _, rest = rname.partition("/")
            if rest == "pe_array" and head[:1] == "u" and \
                    head[1:].isdigit():
                per_unit[int(head[1:])] = u
    for i in sorted(per_unit):
        rows.append((f"unit {i} matrix util", f"{per_unit[i]:.1%}"))
    if not per_unit:
        rows.append(("matrix util", f"{res.utilization:.1%}"))
    if span_log is not None:
        rows.append(_span_audit_row(span_log))
    return _table(rows)


def _write_metrics(reg, path: str) -> None:
    import json
    if path.endswith(".prom"):
        payload = reg.prometheus_text()
    else:
        payload = json.dumps(reg.snapshot(), indent=2,
                             sort_keys=True) + "\n"
    with open(path, "w") as f:
        f.write(payload)
    reg.disable()
    print(f"metrics snapshot -> {path}")


def _run_online(args, cfg, reg) -> None:
    """The ``--qps`` / ``--arrival-trace`` closed-loop path: streaming
    admission + per-epoch re-planning on the modelling backends (no
    weights are instantiated — this is the planning loop, grounded on
    the DES execution path)."""
    from repro_torch.core.config import CASE_STUDY
    from repro_torch.serving.arrivals import (PoissonArrivals,
                                              TraceArrivals, qps_to_gap)
    from repro_torch.serving.online import OnlineServingEngine
    freq = CASE_STUDY.freq_hz
    slo = (None if args.slo_ttft_p99_ms is None
           else args.slo_ttft_p99_ms * 1e-3 * freq)
    if args.arrival_trace is not None:
        src = TraceArrivals(args.arrival_trace)
        offered = "trace"
    else:
        src = PoissonArrivals(mean_gap=qps_to_gap(args.qps, freq),
                              n=args.requests, seed=0)
        offered = f"{args.qps:.0f} req/s"
    execute = args.plan or "desim"
    try:
        eng = OnlineServingEngine(
            cfg, max_batch=args.max_batch, max_new_tokens=args.max_new,
            units=args.plan_units, policy=args.policy,
            overlap=args.overlap, execute_backend=execute,
            ttft_p99_slo=slo, metrics=reg)
        t0 = time.perf_counter()
        res = eng.run(src)
        dt = time.perf_counter() - t0
    except (KeyError, ValueError, OSError) as e:
        raise SystemExit(f"online serving: {e}")
    print(f"[online:{execute}] offered={offered} policy={args.policy}: "
          f"{len(res.completed())}/{len(res.requests)} requests over "
          f"{len(res.epochs)} admission epochs in {dt:.2f}s wall")
    print(_online_summary(res, args.policy, slo))
    if reg is not None and args.metrics_out:
        _write_metrics(reg, args.metrics_out)


def resolve_device(device) -> torch.device:
    """``device`` as given, else the CUDA card; raises without one."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the port runs on the GPU "
                         "(pass --device cpu to run on the CPU)")
    return torch.device("cuda")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ALL_ARCHS, default="yi-6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, required)")
    ap.add_argument("--plan", default=None, metavar="BACKEND",
                    help="price the batch schedule on a modelling backend "
                         "('desim', 'analytical' or 'desim-cluster') "
                         "before serving")
    ap.add_argument("--plan-granularity", default="tile",
                    choices=("tile", "panel", "layer"))
    ap.add_argument("--plan-units", type=int, default=1,
                    help="cluster width for --plan: shard every schedule "
                         "step across N matrix units sharing the memory "
                         "loader (use with --plan desim-cluster or the "
                         "contention-aware analytical form)")
    ap.add_argument("--plan-strategy", default=None,
                    choices=("row-panel", "output-tile", "layer-pipeline",
                             "unit-affinity"),
                    help="partition strategy for a cluster --plan "
                         "(serving GEMMs are wide and short: "
                         "'output-tile' shards their large N dimension; "
                         "'unit-affinity' follows the policy's per-step "
                         "placement hints)")
    ap.add_argument("--policy", default="full-prefill",
                    help="serving batching policy for --plan: "
                         "'full-prefill', 'chunked-prefill', "
                         "'decode-priority', or 'auto' (price every "
                         "policy x partition x overlap candidate with "
                         "the analytical closed form and pick the best)")
    ap.add_argument("--overlap", default="chained",
                    choices=("chained", "relaxed"),
                    help="schedule lowering mode for --plan: 'chained' "
                         "serialises every step, 'relaxed' keeps only "
                         "true per-request hazards so steps on disjoint "
                         "units overlap (ignored by --policy auto, "
                         "which sweeps both)")
    ap.add_argument("--arrival-gap", type=float, default=0.0,
                    metavar="CYCLES",
                    help="inter-request arrival gap in cycles: request i "
                         "arrives at i*GAP, so --plan reports TTFT under "
                         "load instead of the all-at-t=0 lower bound")
    ap.add_argument("--qps", type=float, default=None,
                    help="run the ONLINE closed loop instead of the "
                         "offline plan: seeded Poisson arrivals at this "
                         "offered requests/second rate feed streaming "
                         "admission + per-epoch re-planning "
                         "(repro_torch.serving.online)")
    ap.add_argument("--arrival-trace", default=None, metavar="PATH",
                    help="online mode driven by a JSONL arrival trace "
                         "(one {\"time\": cycles, \"prompt_len\": n} "
                         "object per line) instead of --qps")
    ap.add_argument("--slo-ttft-p99-ms", type=float, default=None,
                    metavar="MS",
                    help="p99 TTFT target in milliseconds: online "
                         "planning goes through the 'auto-slo' sweep "
                         "(cheapest candidate meeting the target) and "
                         "goodput counts only SLO-meeting completions")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="enable the obs metrics registry for this run "
                         "and write its snapshot to PATH on exit (JSON, "
                         "or Prometheus text when PATH ends in .prom)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    disable_tf32()
    reg = None
    if args.metrics_out:
        from repro_torch.obs import enable_metrics
        reg = enable_metrics()

    cfg = get_config(args.arch, reduced=args.reduced)
    if args.reduced:
        cfg = cfg.with_(dtype=torch.float32, kv_cache_dtype=torch.float32)

    if args.qps is not None or args.arrival_trace is not None:
        _run_online(args, cfg, reg)
        return
    gen = torch.Generator(device=device).manual_seed(0)
    params = family_module(cfg).init(cfg, gen, device)

    eng = ServingEngine(cfg, params, max_batch=args.max_batch,
                        cache_len=256)
    rng = np.random.default_rng(1)
    for i in range(args.requests):
        n = 4 + (i * 3) % 12
        eng.submit(torch.from_numpy(rng.integers(0, cfg.vocab_size, n)),
                   arrival_time=i * args.arrival_gap)
    if args.plan:
        from repro_torch.serving.scheduler import (decode_latency_stats,
                                                   price_steps)
        plan_kw = {}
        if args.plan_strategy is not None:
            plan_kw["strategy"] = args.plan_strategy
        try:
            # one pricing pass: the per-step costs feed both the
            # latency stats and the full-schedule total (their sum).
            sched, res = eng.evaluate_schedule(
                args.plan, max_new_tokens=args.max_new,
                units=args.plan_units, policy=args.policy,
                overlap=args.overlap,
                granularity=args.plan_granularity, workload=False,
                **plan_kw)
            step_cycles = price_steps(sched, args.plan,
                                      granularity=args.plan_granularity,
                                      **plan_kw)
            stats = decode_latency_stats(sched, step_cycles,
                                         cfg.n_layers)
        except (KeyError, TypeError, ValueError) as e:
            ap.error(f"--plan: {e}")
        full = sum(step_cycles)
        full_us = full * res.seconds / res.cycles * 1e6
        print(f"[plan:{args.plan}] policy={sched.policy}: "
              f"{len(sched.steps)} steps "
              f"({sum(s.kind == 'prefill' for s in sched.steps)} prefill"
              + (f", {sched.units} units" if sched.units > 1 else "")
              + f"), graph slice {res.cycles:.0f} cyc "
              f"(matrix_util={res.utilization:.1%}); full schedule "
              f"{full:.0f} cyc = {full_us:.1f} us")
        print(f"[plan:{args.plan}] TTFT (first token from arrival) "
              f"p50={stats['ttft_p50']:.0f} cyc "
              f"p99={stats['ttft_p99']:.0f} cyc, inter-token "
              f"p50={stats['itl_p50']:.0f} cyc, "
              f"overlap={sched.overlap} "
              f"makespan={stats['makespan']:.0f} cyc")
        if res.timeline is not None:
            utils = " ".join(f"{k}={v:.1%}"
                             for k, v in res.timeline.utilizations().items())
            print(f"[plan:{args.plan}] per-resource utilization: {utils}")
        print(_plan_summary(stats, res, sched,
                            res.detail.get("span_log")))
    t0 = time.perf_counter()
    outs = eng.run(max_new_tokens=args.max_new,
                   temperature=args.temperature, generator=gen)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    tok = sum(int(o.shape[0]) for o in outs)
    print(f"served {len(outs)} requests, {tok} tokens on {device} "
          f"in {dt:.2f}s ({tok / dt:.1f} tok/s)")
    for i, o in enumerate(outs):
        print(f"  req{i}: {o.tolist()}")
    if reg is not None:
        _write_metrics(reg, args.metrics_out)


if __name__ == "__main__":
    main()
