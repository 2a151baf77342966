"""Count the dry run's cells of the families under the reference's
sequence parallelism (``{"seq": "model"}``) beside the same cells without
it, on the 256-chip pod mesh (``single``: data 16 x model 16).

Each cell is rank 0's step on ``meta`` (``launch.dryrun.run_cell``); a
line a cell and a way gives its status, the roofline's three terms (the
bound is the largest), its collective bytes by kind and its per-rank
temp bytes.  Full-size cells trace for tens of seconds each on a host
core: run it on a machine with cores to spare, e.g.

    PYTHONPATH=src python scripts/sp_dryrun_cells.py --jobs 8

``--out`` keeps the records (one folder a mesh and way) under a
directory of its own, by default ``build/sp_dryrun``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from concurrent.futures import ProcessPoolExecutor, as_completed

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

ARCHS = ("recurrentgemma-2b", "rwkv6-7b", "whisper-tiny", "olmoe-1b-7b",
         "internvl2-1b")
SHAPES = ("train_4k", "prefill_32k")
WAYS = {"seq": {"seq": "model"}, "none": None}


def one(job):
    arch, shape, way, out_dir = job
    from repro_torch.launch import dryrun
    r = dryrun.run_cell(arch, shape, "single", force=True,
                        tag="" if way == "none" else f"_{way}",
                        out_dir=out_dir, rules=WAYS[way])
    line = {"arch": arch, "shape": shape, "rules": WAYS[way],
            "status": r["status"]}
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
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "build",
        "sp_dryrun"))
    args = ap.parse_args(argv)
    jobs = [(a, s, w, args.out) for a in ARCHS for s in SHAPES for w in WAYS]
    bad = 0
    with ProcessPoolExecutor(args.jobs) as pool:
        for done in as_completed([pool.submit(one, job) for job in jobs]):
            line = done.result()
            print(json.dumps(line), flush=True)
            bad += line["status"] != "ok"
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
