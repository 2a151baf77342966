"""Roofline report: reads the dry run's records and renders the
per-(arch × shape × mesh) three-term table.

    PYTHONPATH=src python -m repro_torch.launch.roofline \\
        [--results DIR] [--mesh h100|single|multi] [--tag TAG]

The port's counterpart of the reference's ``benchmarks/roofline.py``, over
the records ``launch/dryrun.py::run_cell`` writes (by default under its
``RESULTS_DIR``): one folder a mesh, ``h100`` (one card) and the
reference's pods ``single`` and ``multi``.  A row's ``hbm_ok`` holds its
temp plus argument bytes, a card's, against the H100's memory
(``core.hardware.TARGET_CHIP.hbm_bytes``, 80 GB).  The hillclimb picks
are made over one mesh (``--mesh``, ``h100`` by default).  A record the
dry run could not count (``"status": "not_ported"``) has no roofline and
is left out.
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.core.hardware import TARGET_CHIP
from repro_torch.launch.dryrun import MESHES, RESULTS_DIR

_SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
_MESH_LABEL = {"h100": "one-card (h100)", "single": "single-pod",
               "multi": "multi-pod"}


def load_rows(results_dir: str = RESULTS_DIR, tag: str = "") -> "list[dict]":
    rows = []
    for mesh in MESHES:
        d = os.path.join(results_dir, mesh + tag)
        if not os.path.isdir(d):
            continue
        for fn in sorted(os.listdir(d)):
            with open(os.path.join(d, fn)) as f:
                r = json.load(f)
            if "roofline" not in r:
                continue
            roof, mem = r["roofline"], r["memory"]
            rows.append({
                "arch": r["arch"], "shape": r["shape"], "mesh": mesh,
                "mode": r["mode"], "chips": r["chips"],
                "compute_s": roof["compute_s"], "memory_s": roof["memory_s"],
                "collective_s": roof["collective_s"],
                "dominant": roof["dominant"],
                "frac": roof["roofline_fraction"],
                "useful": roof["useful_flops_ratio"],
                "coll_share": roof["collective_s"] / max(
                    roof["compute_s"], roof["memory_s"],
                    roof["collective_s"], 1e-30),
                "temp_gb": (mem["temp_bytes"] or 0) / 2**30,
                "hbm_ok": ((mem["temp_bytes"] or 0)
                           + (mem["argument_bytes"] or 0))
                          < TARGET_CHIP.hbm_bytes,
            })
    rows.sort(key=lambda r: (r["mesh"], r["arch"],
                             _SHAPE_ORDER.index(r["shape"])))
    return rows


def render_markdown(rows, mesh: str = "h100") -> str:
    out = ["| arch | shape | compute s | memory s | collective s | "
           "dominant | MODEL/HLO flops | roofline frac | temp GiB |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["mesh"] != mesh:
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.2e} | "
            f"{r['memory_s']:.2e} | {r['collective_s']:.2e} | "
            f"{r['dominant']} | {r['useful']:.2f} | {r['frac']:.3f} | "
            f"{r['temp_gb']:.1f} |")
    return "\n".join(out)


def summarize(results_dir: str = RESULTS_DIR, print_table: bool = True,
              tag: str = ""):
    rows = load_rows(results_dir, tag)
    if print_table and rows:
        for mesh in MESHES:
            if any(r["mesh"] == mesh for r in rows):
                print(f"\n== {_MESH_LABEL[mesh]} mesh ==")
                print(render_markdown(rows, mesh))
    return rows


def pick_hillclimb_cells(rows, mesh: str = "h100"):
    """Assignment rule: worst roofline fraction, most collective-bound,
    most representative of the paper's technique (GEMM-dominated train),
    over the rows of ``mesh``.

    Decode cells are excluded from the "worst fraction" pick: their
    fraction is bounded by decode arithmetic intensity (tokens a card),
    not by the implementation.
    """
    on_mesh = [r for r in rows if r["mesh"] == mesh]
    improvable = [r for r in on_mesh if r["mode"] != "decode"]
    worst = min(improvable, key=lambda r: r["frac"] if r["frac"] > 0 else 1e9)
    coll = max(on_mesh, key=lambda r: r["coll_share"])
    train = [r for r in on_mesh if r["mode"] == "train"]
    rep = max(train, key=lambda r: r["compute_s"])
    return {"worst_fraction": worst, "most_collective": coll,
            "paper_representative": rep}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=RESULTS_DIR,
                    help="the dry run's results directory (one folder a "
                         "mesh)")
    ap.add_argument("--mesh", choices=tuple(MESHES), default="h100",
                    help="the mesh the hillclimb picks are made over")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    rows = summarize(args.results, tag=args.tag)
    picks = None
    if any(r["mesh"] == args.mesh for r in rows):
        picks = pick_hillclimb_cells(rows, args.mesh)
        print(f"\n== hillclimb picks ({args.mesh}) ==")
        for why, r in picks.items():
            print(f"{why}: {r['arch']} x {r['shape']} "
                  f"(frac={r['frac']:.3f}, dominant={r['dominant']}, "
                  f"coll_share={r['coll_share']:.2f})")
    return rows, picks


if __name__ == "__main__":
    main()
