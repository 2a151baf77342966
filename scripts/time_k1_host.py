#!/usr/bin/env python
"""Host microseconds of one K1 call, on each tile and through the wrapper,
for the checkout in the current directory.

    python scripts/time_k1_host.py [--reps 5]

Run from the root of a checkout (this script may live in another one):
it imports that checkout's ``chip_smoke.py`` and ``src/repro_torch`` and
repeats ``chip_smoke.k1_host_us`` (200 calls enqueued back to back, at a
shape whose device time is a few microseconds, timed on the host's clock
to a synchronize) ``--reps`` times.  One JSON line: the card's name and
power limit, each repetition, and the median of each figure.  Comparing
two checkouts means running both in one call, in turns (parent, change,
change, parent), as the figures move with the host.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    root = os.getcwd()
    sys.path[:0] = [root, os.path.join(root, "src")]
    import chip_smoke

    line = chip_smoke.phase_device()
    runs = [chip_smoke.k1_host_us() for _ in range(args.reps)]
    print(json.dumps({
        "checkout": root, "card": line, "runs": runs,
        "median_us": {k: statistics.median(r[k] for r in runs)
                      for k in runs[0]}}), flush=True)


if __name__ == "__main__":
    main()
