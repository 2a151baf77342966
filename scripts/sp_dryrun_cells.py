"""Count dry-run cells under one of the reference's rule sets beside
the same cells under the default rules, on the 256-chip pod mesh
(``single``: data 16 x model 16).  ``--set`` picks them:

* ``seq``: the five families' ``train_4k`` and ``prefill_32k`` under
  sequence parallelism (``{"seq": "model"}``);
* ``gspmd``: the MoE models' ``train_4k`` under perf_iter's
  ``ar_gspmd_ep`` rules (GSPMD expert parallelism: the experts over
  data, each expert's d_ff over model, ``moe_shard_map=False``).

Each cell is rank 0's step on ``meta`` (``launch.dryrun.run_cell``); a
line a cell and a way gives its status, the roofline's three terms (the
bound is the largest), its collective bytes by kind and its per-rank
argument and temp bytes.  Full-size cells trace for tens of seconds to
minutes each on a host core: run it on a machine with cores to spare,
e.g.

    PYTHONPATH=src python scripts/sp_dryrun_cells.py --jobs 8
    PYTHONPATH=src python scripts/sp_dryrun_cells.py --set gspmd --jobs 4

``--out`` keeps the records (one folder a mesh and way) under a
directory of its own, by default ``build/<set>_dryrun``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from concurrent.futures import ProcessPoolExecutor, as_completed

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

#: set -> (archs, shapes, {way: (rules, config overrides)}); way "none"
#: is the default rules
SETS = {
    "seq": (("recurrentgemma-2b", "rwkv6-7b", "whisper-tiny",
             "olmoe-1b-7b", "internvl2-1b"), ("train_4k", "prefill_32k"),
            {"seq": ({"seq": "model"}, None), "none": (None, None)}),
    "gspmd": (("olmoe-1b-7b", "arctic-480b"), ("train_4k",),
              {"ar_gspmd_ep": ({"experts": "data", "mlp_expert": "model",
                                "embed": None}, {"moe_shard_map": False}),
               "none": (None, None)}),
}


def one(job):
    arch, shape, (way, (rules, overrides)), out_dir = job
    from repro_torch.launch import dryrun
    r = dryrun.run_cell(arch, shape, "single", force=True,
                        tag="" if way == "none" else f"_{way}",
                        out_dir=out_dir, rules=rules, overrides=overrides)
    line = {"arch": arch, "shape": shape, "rules": rules,
            "overrides": overrides, "status": r["status"]}
    if r["status"] != "ok":
        return {**line, "reason": r.get("reason")}
    roof = r["roofline"]
    terms = {k: roof[k] for k in ("compute_s", "memory_s", "collective_s")}
    return {**line, **terms, "bound_s": max(terms.values()),
            "dominant": roof["dominant"],
            "collective_bytes": r["collective_bytes"],
            "temp_bytes": r["memory"]["temp_bytes"],
            "argument_bytes": r["memory"]["argument_bytes"],
            "trace_s": r["trace_s"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--set", choices=tuple(SETS), default="seq")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    out = args.out or os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "build", f"{args.set}_dryrun")
    archs, shapes, ways = SETS[args.set]
    jobs = [(a, s, w, out) for a in archs for s in shapes
            for w in ways.items()]
    bad = 0
    with ProcessPoolExecutor(args.jobs) as pool:
        for done in as_completed([pool.submit(one, job) for job in jobs]):
            line = done.result()
            print(json.dumps(line), flush=True)
            bad += line["status"] != "ok"
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
