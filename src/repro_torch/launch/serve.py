"""Serving launcher: batched generation through the port's kernels.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \\
        --reduced --requests 6 --max-new 16

Runs on the CUDA card; ``--device cpu`` runs the kernels' plain versions
on the CPU instead.  Without ``--device`` and without a card it stops
with an error rather than falling back to the CPU.  The reference's
planning and online modes (``--plan``, ``--qps``, ``--arrival-trace``)
are not ported yet.
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
    for flag in ("--plan", "--qps", "--arrival-trace"):
        ap.add_argument(flag, default=None, help="not ported yet")
    args = ap.parse_args(argv)
    for flag in ("plan", "qps", "arrival_trace"):
        if getattr(args, flag) is not None:
            raise SystemExit(f"--{flag.replace('_', '-')} is not yet ported")

    device = resolve_device(args.device)
    disable_tf32()
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.reduced:
        cfg = cfg.with_(dtype=torch.float32, kv_cache_dtype=torch.float32)
    gen = torch.Generator(device=device).manual_seed(0)
    params = family_module(cfg).init(cfg, gen, device)

    eng = ServingEngine(cfg, params, max_batch=args.max_batch,
                        cache_len=256)
    rng = np.random.default_rng(1)
    for i in range(args.requests):
        n = 4 + (i * 3) % 12
        eng.submit(torch.from_numpy(rng.integers(0, cfg.vocab_size, n)))
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


if __name__ == "__main__":
    main()
