#!/usr/bin/env python
"""Time the two ways expert parallelism can sum OLMoE-1B-7B's MoE output
over the ``model`` axis, on two ranks of this machine's cards.

    PYTHONPATH=src python scripts/time_ep_allreduce.py [--reps 20]

Each rank holds 32 of the 64 experts of one layer at full width (bf16,
seeded) and takes the serve traffic's token counts (the two prefills,
4 x 221 and 4 x 90 padded tokens, and a decode step's 4).  The two sums:

- ``partial``: each rank's partial output (T, d) is all-reduced, as the
  reference's ``psum`` and ``models/moe.py`` do;
- ``slot-wise``: each token's top-k gate-weighted expert outputs
  (T, k, d) are all-reduced and then added (k times the volume; each
  slot is nonzero on one rank, so the sum is exact).

Per rank and token count, one JSON line gives CUDA-event medians (ms) of
the rank's local work (``moe_apply_local`` over its experts, no
collective), each all-reduce alone, the k adds after the slot-wise one,
and ``moe_apply`` on the mesh (the local work and the partial
all-reduce, as the model runs it); the slot-wise layer is the sum of its
parts.  The ranks join through ``launch.mesh.run_world``: NCCL when each
has a card of its own, gloo when they share one (then the all-reduces
cross the host).  The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch                                                # noqa: E402

import chip_smoke as smoke                                  # noqa: E402

RANKS = 2


def _median_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def _rank(world, reps: int) -> None:
    from repro_torch.configs.registry import get_config
    from repro_torch.core.precision import disable_tf32
    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    disable_tf32()
    cfg = get_config(smoke.MOE_ARCH)
    m, d = cfg.moe, cfg.d_model
    mesh = make_mesh((1, RANKS), ("data", "model"))
    group = mesh.group("model")
    shard, e_local = mesh.index("model"), m.n_experts // RANKS
    whole = moe.moe_init(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    w = slice(shard * e_local, (shard + 1) * e_local)
    p = {"w_router": whole["w_router"],
         "experts_wi": whole["experts_wi"][w].clone(),
         "experts_wo": whole["experts_wo"][w].clone()}
    del whole
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(1)
    b = smoke.MAX_BATCH
    seqs = {f"prefill {i + 1}": s for i, s in enumerate(
        smoke.padded_lengths(smoke.prompt_lengths()[0]))}
    seqs["decode"] = 1
    for tag, s in seqs.items():
        x = torch.randn((b, s, d), generator=gen, device="cuda").to(cfg.dtype)
        t = b * s
        cap = moe.moe_capacity(cfg, t)

        def local():
            return moe.moe_apply_local(cfg, x.reshape(-1, d), p["w_router"],
                                       p["experts_wi"], p["experts_wo"],
                                       shard * e_local, cap)
        part = local()
        slots = torch.randn((t, m.top_k, d), generator=gen,
                            device="cuda").to(cfg.dtype)

        def combine():
            out = torch.zeros_like(slots[:, 0])
            for j in range(m.top_k):
                out = out + slots[:, j]
            return out
        row = {
            "rank": world.rank, "backend": world.backend,
            "tokens": tag, "T": t, "d": d, "k": m.top_k,
            "partial_bytes": part.numel() * part.element_size(),
            "slot_bytes": slots.numel() * slots.element_size(),
            "local_ms": _median_ms(local, reps),
            "allreduce_partial_ms": _median_ms(
                lambda: collectives.all_reduce(part, group), reps),
            "allreduce_slots_ms": _median_ms(
                lambda: collectives.all_reduce(slots, group), reps),
            "combine_ms": _median_ms(combine, reps),
            "moe_apply_ms": _median_ms(
                lambda: moe.moe_apply(cfg, p, x, mesh=mesh), reps)}
        row["slot_wise_layer_ms"] = (row["local_ms"]
                                     + row["allreduce_slots_ms"]
                                     + row["combine_ms"])
        print(json.dumps(row), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("time_ep_allreduce: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    from repro_torch.launch.mesh import run_world
    rdv = ROOT / "build" / "ep_allreduce_rendezvous"
    rdv.parent.mkdir(parents=True, exist_ok=True)
    run_world(_rank, RANKS, (args.reps,), rendezvous=str(rdv), timeout=600)


if __name__ == "__main__":
    main()
