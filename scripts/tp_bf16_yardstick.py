#!/usr/bin/env python
"""Hold phase ``dist-tp``'s bf16 yardstick against two known faults of the
tensor-parallel path, on this machine's first card.

    PYTHONPATH=src python scripts/tp_bf16_yardstick.py [--seeds 7 8 9] \
        [--arch yi-6b] [--ranks 2]

yi-6b (``--arch``: or RecurrentGemma-2B or RWKV-6-7B, whose limits
phase ``dist-rec`` holds) at full width and depth in bf16 serves the
serve traffic's first batch (4 prompts padded to 221 tokens) and 4
decode steps, as ``chip_smoke.py::_mesh_serve`` does, first on one rank
in bf16 and in fp32 (the fp32 run decodes the bf16 run's tokens), then
on ``--ranks`` ranks of a (data 1, model ranks) mesh in bf16, decoding
the same tokens.  A
sound tensor-parallel path rounds as one rank does, in another order, so
its distance from the fp32 logits is about one rank's, and its distance
from one rank's bf16 logits is a share of that.  At each of the 5 logits
a line gives the distances between the three runs, as a max-norm and as
an RMS distance (each relative to the second run's max or RMS), and the
ratio phase ``dist-tp`` holds (``chip_smoke.TOL_TP_BF16``): the 2-norm
of the TP logits' distance from one rank's bf16 logits over that of one
rank's bf16 logits from its fp32 ones.

Each seed's weights run three variants on the ranks:

- ``sound``: the path as it is;
- ``round-twice``: each row-parallel projection's partial product is
  rounded to bf16 before the ranks' sum, which rounds again
  (``models/common.py::row_parallel`` replaced in memory);
- a head swap on rank 1, in memory: yi-6b's ``kv-swap`` (its two KV
  heads swapped, ``models/common.py::_qkv_placed``'s output permuted),
  RecurrentGemma's ``q-swap`` (its q heads in reverse order, the same
  output) and RWKV-6's ``r-swap`` (the receptance's heads in reverse
  order at the WKV, ``models/rwkv6.py::_wkv_stateful``'s input).

The faults are patched into the ranks' processes only; no file changes.
One JSON line a seed and variant (from rank 0), after the card's name and
power limit.  The ranks join through ``launch.mesh.run_world`` (gloo when
they share the card).
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

OUT = ROOT / "build" / "tp_bf16_yardstick"
#: each architecture's head swap (the third variant)
SWAP = {"yi-6b": "kv-swap", "recurrentgemma-2b": "q-swap",
        "rwkv6-7b": "r-swap"}


def _rms_rel(out, ref) -> float:
    o, r = out.double(), ref.double()
    return float((o - r).square().mean().sqrt() / r.square().mean().sqrt())


def _distances(logits, ref) -> dict:
    return {"max": [smoke.rel_err(a, b)[0] for a, b in zip(logits, ref)],
            "rms": [_rms_rel(a, b) for a, b in zip(logits, ref)]}


def _config(arch, dtype):
    return smoke._cut(arch, None, dtype=dtype, kv_cache_dtype=dtype)


def _one_rank(arch, seeds) -> None:
    """One rank's bf16 and fp32 runs of each seed, saved for the ranks."""
    from repro_torch.models.base import family_module
    for seed in seeds:
        runs = {}
        for tag, dtype in (("bf16", torch.bfloat16),
                           ("fp32", torch.float32)):
            cfg = _config(arch, dtype)
            mod = family_module(cfg)
            params = mod.init(cfg, torch.Generator(
                device="cuda").manual_seed(seed), "cuda")
            cache = mod.init_cache(cfg, smoke.MAX_BATCH, smoke.CACHE_LEN,
                                   device="cuda")
            follow = runs["bf16"]["greedy"][:, :-1] if tag == "fp32" else None
            runs[tag] = smoke._mesh_serve(cfg, params, cache, follow)
            del runs[tag]["cache"], runs[tag]["batch"], params, cache
            torch.cuda.empty_cache()
        torch.save(runs, OUT / f"one_{seed}.pt")


def _rank(world, arch, seeds) -> None:
    import torch.distributed as dist
    from repro_torch.core import tree
    from repro_torch.core.precision import disable_tf32
    from repro_torch.distributed import logical, sharding
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import common as cm
    from repro_torch.models import rwkv6
    from repro_torch.models.base import family_module
    disable_tf32()
    row_parallel, qkv_placed = cm.row_parallel, cm._qkv_placed
    wkv_stateful = rwkv6._wkv_stateful

    def round_twice(cfg, pl, x, w, *rest):
        y = cm.linear(x, w, backend=cm._mm_backend(cfg))    # bf16 partial
        return pl.exit(y, *rest)

    def kv_swap(cfg, pl, *rest):
        q, k, v = qkv_placed(cfg, pl, *rest)
        if pl.rank == 1:
            k, v = k.flip(1), v.flip(1)
        return q, k, v

    def q_swap(cfg, pl, *rest):
        q, k, v = qkv_placed(cfg, pl, *rest)
        return (q.flip(1) if pl.rank == 1 else q), k, v

    def r_swap(cfg, r, *rest):
        if tp.current().rank == 1:
            r = r.flip(1)
        return wkv_stateful(cfg, r, *rest)

    mesh = make_mesh((1, world.size), ("data", "model"))
    cfg = _config(arch, torch.bfloat16)
    mod = family_module(cfg)
    swap = SWAP[arch]
    for seed in seeds:
        one = torch.load(OUT / f"one_{seed}.pt")
        for turn in range(world.size):     # one whole model at a time
            if turn == world.rank:
                whole = mod.init(cfg, torch.Generator(
                    device="cuda").manual_seed(seed), "cuda")
                params = sharding.shard_params(whole, mesh, glu=cfg.mlp_glu)
                del whole
                torch.cuda.empty_cache()
            dist.barrier()
        for variant in ("sound", "round-twice", swap):
            cm.row_parallel = (round_twice if variant == "round-twice"
                               else row_parallel)
            cm._qkv_placed = {"kv-swap": kv_swap, "q-swap": q_swap}.get(
                variant, qkv_placed)
            rwkv6._wkv_stateful = (r_swap if variant == "r-swap"
                                   else wkv_stateful)
            cache = tree.tree_map(
                lambda x: torch.zeros(x.shape, dtype=x.dtype, device="cuda"),
                sharding.shard_cache(mod.init_cache(
                    cfg, smoke.MAX_BATCH, smoke.CACHE_LEN, device="meta"),
                    mesh, cfg))
            with logical.use_rules(mesh):
                got = smoke._mesh_serve(cfg, params, cache,
                                        follow=one["bf16"]["greedy"][:, :-1])
            del cache
            tp_fp32 = _distances(got["logits"], one["fp32"]["logits"])
            one_fp32 = _distances(one["bf16"]["logits"],
                                  one["fp32"]["logits"])
            if world.rank == 0:
                print(json.dumps({
                    "arch": arch, "ranks": world.size,
                    "seed": seed, "variant": variant,
                    "backend": world.backend,
                    "tp_vs_one_bf16": _distances(got["logits"],
                                                 one["bf16"]["logits"]),
                    "tp_vs_fp32": tp_fp32, "one_bf16_vs_fp32": one_fp32,
                    "tp_vs_fp32_over_one_bf16_vs_fp32": {
                        k: [a / b for a, b in zip(tp_fp32[k], one_fp32[k])]
                        for k in tp_fp32},
                    "dist_tp_ratio": [
                        smoke.l2_dist(a, b) / smoke.l2_dist(b, c)
                        for a, b, c in zip(got["logits"],
                                           one["bf16"]["logits"],
                                           one["fp32"]["logits"])],
                    "tol_ratio": smoke.TOL_TP_BF16,
                    "greedy_agree": float((got["greedy"] == one["bf16"][
                        "greedy"]).float().mean())}), flush=True)
    cm.row_parallel, cm._qkv_placed = row_parallel, qkv_placed
    rwkv6._wkv_stateful = wkv_stateful


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[7, 8, 9])
    ap.add_argument("--arch", choices=tuple(SWAP), default="yi-6b")
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("tp_bf16_yardstick: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    from repro_torch.core.precision import disable_tf32
    from repro_torch.launch.mesh import run_world
    disable_tf32()
    OUT.mkdir(parents=True, exist_ok=True)
    _one_rank(args.arch, args.seeds)
    run_world(_rank, args.ranks, (args.arch, args.seeds),
              rendezvous=str(OUT / "rendezvous"),
              timeout=300 + 200 * len(args.seeds))


if __name__ == "__main__":
    main()
