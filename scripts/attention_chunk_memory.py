#!/usr/bin/env python
"""What the chunked attention's per-chunk remat saves in a train step, on
the card and in the dry run's counter.

    python scripts/attention_chunk_memory.py [--layers 2] [--seq 4096]

yi-6b at full width cut to ``--layers`` layers, bf16, remat "full", one
sequence of ``--seq`` tokens (``attn_chunk`` 1024: ``seq / 1024`` KV
chunks), attention on the plain chunked route as the launcher trains it:
one ``value_and_grad`` with each KV chunk step under ``checkpoint``
(``models/common.py::attention_chunked``), then with the step run
directly.  For each: the card's peak allocation over what it held before
the step, the median CUDA-event ms of 3 steps, and ``temp_bytes`` of the
cost counter's trace of the same step on ``meta`` (``core.hlo_cost``).
The two ways' gradients must be equal bit for bit, and the second way
must have run chunk steps directly (it exits 1 if it ran none: the step
was renamed or no longer runs under ``checkpoint``).  One JSON line a way,
with the card's name and power limit.  Run from the root of a checkout.

    python scripts/attention_chunk_memory.py --cell yi-6b:train_4k

instead counts that cell of the one-card dry run (``launch/dryrun.py``,
on ``meta``, no card needed) both ways: its ``temp_bytes``, FLOPs and
bytes, one JSON line a way.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--cell", default=None, help="arch:shape of the dry run")
    args = ap.parse_args()
    root = os.getcwd()
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch

    from repro_torch.models import common as cm
    checkpointed = cm.checkpoint

    ran_direct = [0]

    def direct(fn, *a, **kw):
        # the chunk step runs as it is; a layer's remat stays
        if fn.__name__ == "step":
            ran_direct[0] += 1
            return fn(*a)
        return checkpointed(fn, *a, **kw)

    if args.cell:
        _count_cell(args.cell, cm, checkpointed, direct, ran_direct)
        return

    import chip_smoke
    from repro_torch.configs.registry import get_config
    from repro_torch.core import hlo_cost, tree
    from repro_torch.core.precision import disable_tf32
    from repro_torch.models.base import family_module
    from repro_torch.training import train_step as ts

    card = chip_smoke.phase_device()
    disable_tf32()
    cfg = get_config("yi-6b").with_(n_layers=args.layers, backend="torch")
    tcfg = ts.TrainConfig(loss_chunk=512)
    mod = family_module(cfg)
    params = mod.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                      "cuda")
    batch = chip_smoke.train_batch(cfg, 1, args.seq, "cuda")
    meta_params = mod.init(cfg, None, "meta")
    meta_batch = {k: torch.empty_like(v, device="meta")
                  for k, v in batch.items()}
    grads = {}
    for way, ckpt in (("per-chunk remat", checkpointed),
                      ("no chunk remat", direct)):
        cm.checkpoint = ckpt
        try:
            def step(p, b):
                return ts.value_and_grad(cfg, tcfg, p, b)
            with hlo_cost.counting() as counter:
                step(meta_params, meta_batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            live = torch.cuda.memory_allocated()
            _, _, g = step(params, batch)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - live
            grads[way] = tree.leaves(g)
            del g
            ms = []
            for _ in range(3):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                step(params, batch)
                e1.record()
                torch.cuda.synchronize()
                ms.append(e0.elapsed_time(e1))
        finally:
            cm.checkpoint = checkpointed
        _require_direct(way, ran_direct)
        print(json.dumps({
            "way": way, "card": card, "config": f"yi-6b full width, "
            f"{cfg.n_layers} layers, bf16, remat {cfg.remat}, 1 x "
            f"{args.seq} tokens, attn_chunk {cfg.attn_chunk}",
            "peak_over_live_bytes": peak, "step_ms_median": statistics
            .median(ms), "step_ms": ms,
            "meta_temp_bytes": counter.cost.temp_bytes}), flush=True)
        torch.cuda.empty_cache()
    same = all(torch.equal(a, b) for a, b in zip(*grads.values()))
    print(json.dumps({"gradients_bit_for_bit": same}), flush=True)
    if not same:
        sys.exit(1)


def _require_direct(way, ran_direct):
    if way == "no chunk remat" and not ran_direct[0]:
        sys.exit("no chunk remat: no chunk step ran outside checkpoint; "
                 "the two ways measured the same configuration")


def _count_cell(cell, cm, checkpointed, direct, ran_direct):
    import tempfile

    from repro_torch.launch import dryrun
    arch, shape = cell.split(":")
    for way, ckpt in (("per-chunk remat", checkpointed),
                      ("no chunk remat", direct)):
        cm.checkpoint = ckpt
        try:
            with tempfile.TemporaryDirectory() as out:
                r = dryrun.run_cell(arch, shape, out_dir=out)
        finally:
            cm.checkpoint = checkpointed
        _require_direct(way, ran_direct)
        print(json.dumps({
            "way": way, "cell": cell, "status": r["status"],
            "temp_bytes": r["memory"]["temp_bytes"],
            "argument_bytes": r["memory"]["argument_bytes"],
            "flops": r["cost_analysis"]["flops"],
            "bytes": r["cost_analysis"]["bytes accessed"],
            "trace_s": r["trace_s"]}), flush=True)


if __name__ == "__main__":
    main()
