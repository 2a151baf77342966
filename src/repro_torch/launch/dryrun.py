"""One-card dry run: count every (arch × shape) cell on ``meta`` tensors.

For each cell this builds the parameters and optimizer state
(``training.train_step.abstract_state``), the batch
(``configs.registry.input_specs``) and the cache on the ``meta`` device
(shapes and dtypes, no memory), runs the cell's step (``train_step``,
``prefill`` or ``decode_step``) once under the cost counter
(``core.hlo_cost``: every aten op, and K1–K6 by their launch formulas,
nothing launched), and writes the reference's record
(``repro.launch.dryrun.run_cell``: ``mode``, ``memory``,
``collective_bytes``, ``unparsed_loops``, ``model_flops_total``,
``roofline``) into ``<out>/<mesh>/<arch>__<shape>.json``, by default
under ``benchmarks/results/dryrun_torch/``.

The meshes are ``h100``, one card, and the reference's pods: ``single``
(16 × 16 = 256 chips over data and model) and ``multi`` (2 × 16 × 16 =
512 over pod, data and model).  On a pod mesh the cell is rank 0's
program: its parameters, optimizer state, batch rows and cache are its
shards under the default rules (``distributed.sharding``), built on
``meta`` and run under a ``launch.mesh.rank_view`` at rank 0's
coordinate, each collective recorded by kind and bytes, none run
(``distributed.collectives``).  The record carries the reference's
per-chip fields: ``chips``, the roofline's ``model_flops_per_chip`` (the
model's FLOPs over the chips), the argument bytes of the rank's shards
and its collective bytes by kind.  The roofline's collective term
divides by the card's NVLink rate (``core.hardware``); a pod's axes that
cross nodes run over the network, so on a real pod that term is a lower
bound.  Where the reference lowers and compiles (``lower_s``,
``compile_s``, XLA's ``cost_analysis``, the HLO's size), this records the
host seconds of building the cell (``build_s``) and of running it under
the counter (``trace_s``), the counter's own totals (``cost_analysis``)
and its table by kernel (``kernels``).  A cell the port cannot run, which
raises ``repro_torch.NotPorted`` (a kernel's autograd refusal; every
placement of the rules runs), is written with ``"status": "not_ported"``
and the refusal's text; any other error fails the cell.  Every cell of the pod
grid runs: all 64 are ``ok``.

Usage:
    python -m repro_torch.launch.dryrun --arch yi-6b --shape decode_32k
    python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k \\
        --mesh single
    python -m repro_torch.launch.dryrun --all [--meshes single multi] \\
        [--jobs 2] [--force]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback

import torch
from torch.utils._pytree import tree_leaves

from repro_torch import NotPorted

from repro_torch.configs.registry import (ALL_ARCHS, SHAPES, ShapeSpec,
                                          all_cells, cell_applicable,
                                          get_config, input_specs)
from repro_torch.core import hlo_cost, tree
from repro_torch.core import roofline as rl
from repro_torch.core.hardware import TARGET_CHIP
from repro_torch.distributed import logical, sharding
from repro_torch.launch.mesh import rank_view
from repro_torch.models.base import family_module
from repro_torch.optim import adamw
from repro_torch.training.train_step import (TrainConfig, abstract_state,
                                             make_train_step)

RESULTS_DIR = os.path.join(os.path.dirname(__file__),
                           "../../../benchmarks/results/dryrun_torch")
#: mesh name -> (sizes, axis names); the chips are their product
MESHES = {"h100": ((1,), ("data",)),
          "single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def chips_of(mesh_name: str) -> int:
    return math.prod(MESHES[mesh_name][0])


def rank_mesh(mesh_name: str):
    """Rank 0 of a pod mesh, without a world; None for one card."""
    if chips_of(mesh_name) == 1:
        return None
    return rank_view(*MESHES[mesh_name])


def _result_path(out_dir: str, mesh_name: str, arch: str, shape: str,
                 tag: str = "") -> str:
    d = os.path.join(os.path.abspath(out_dir), mesh_name + tag)
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{arch}__{shape}.json")


def default_train_config(cfg, spec: ShapeSpec, chip=TARGET_CHIP,
                         mesh=None) -> TrainConfig:
    """Pick microbatches so the activation carry fits the card's memory.

    The reference bounds its layer-scan carry (one residual-stream tensor
    a layer: B_local × S × d_model × 2 bytes × n_layers) by 4 GiB a chip
    over its data axis; on one card B_local is the global batch and the
    bound is the card's HBM.  On a pod mesh the reference's rule holds as
    it is.  Gradient accumulation divides B_local.
    """
    data = 1 if mesh is None else (mesh.shape.get("data", 1)
                                   * mesh.shape.get("pod", 1))
    b_local = max(spec.global_batch // data, 1)
    carry = b_local * spec.seq_len * cfg.d_model * 2 * cfg.n_layers
    target = chip.hbm_bytes if mesh is None else 4 * (1 << 30)
    mb = 1
    while mb < b_local and carry / mb > target:
        mb *= 2
    return TrainConfig(microbatches=mb)


def step_fn(cfg, mode: str, tcfg: TrainConfig = None):
    """The function a cell of ``mode`` runs: the train step (params,
    opt_state, batch[, residual]), ``prefill`` (params, batch, cache) or
    ``decode_step`` (params, tokens, cache, pos)."""
    mod = family_module(cfg)
    if mode == "train":
        step = make_train_step(cfg, tcfg or TrainConfig())
        return lambda p, o, b, r=None: step(p, o, b, r)[:3]
    if mode == "prefill":
        return lambda p, b, c: mod.prefill(cfg, p, b, c)
    return lambda p, t, c, pos: mod.decode_step(cfg, p, t, c, pos)


def build_cell(cfg, shape_name: str, tcfg: TrainConfig = None, mesh=None,
               rules=None):
    """(fn, abstract args, cfg it runs) for one cell, on ``meta``; on a
    rank ``mesh``, the rank's shards (call it under ``logical.use_rules``
    of the same mesh and rules).

    Training runs on the plain ``torch`` route (attention, experts,
    recurrences), as ``launch/train.py`` does (K2, K4, K5 and K6 have no
    backward), the projections through K1; serving on the kernels.  A
    decode step writes the cache's last slot and attends to all of it.
    """
    spec = SHAPES[shape_name]
    mod = family_module(cfg)
    batch = input_specs(cfg, spec)
    if spec.mode == "train":
        cfg = cfg.with_(backend="torch")
        tcfg = tcfg or default_train_config(cfg, spec, mesh=mesh)
        params, opt_state = abstract_state(cfg, tcfg)
        if mesh is not None:
            params = sharding.shard_params(params, mesh, rules,
                                           glu=cfg.mlp_glu)
            opt_state = adamw.init(tcfg.optimizer, params)
            batch = sharding.local_batch(batch, mesh, tcfg.microbatches,
                                         rules)
        args = (params, opt_state, batch)
        if tcfg.grad_compression:     # the error-feedback residual
            args += (tree.tree_map(lambda x: torch.empty(
                x.shape, dtype=torch.float32, device="meta"), params),)
        return step_fn(cfg, "train", tcfg), args, cfg
    params = mod.init(cfg, None, "meta")
    cache = mod.init_cache(cfg, spec.global_batch, spec.seq_len,
                           device="meta")
    if mesh is not None:
        params = sharding.shard_params(params, mesh, rules, glu=cfg.mlp_glu)
        cache = sharding.shard_cache(cache, mesh, cfg, rules)
        batch = sharding.local_batch(batch, mesh, 1, rules)
    if spec.mode == "prefill":
        return step_fn(cfg, "prefill"), (params, batch, cache), cfg
    return (step_fn(cfg, "decode"),
            (params, batch["tokens"], cache, spec.seq_len - 1), cfg)


def model_flops(cfg, shape_name: str) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE); D per mode."""
    spec = SHAPES[shape_name]
    n = cfg.param_count(active_only=cfg.moe is not None)
    d_tokens = spec.global_batch * (1 if spec.mode == "decode"
                                    else spec.seq_len)
    mult = 6.0 if spec.mode == "train" else 2.0
    return mult * n * d_tokens


def tree_bytes(obj) -> int:
    return sum(hlo_cost.tensor_bytes(t) for t in tree_leaves(obj)
               if isinstance(t, torch.Tensor))


def count_step(fn, args, train: bool):
    """(cost, result, host s) of ``fn(*args)`` under the counter; a
    serving step runs without autograd."""
    t0 = time.time()
    with torch.set_grad_enabled(train), hlo_cost.counting() as counter:
        out = fn(*args)
    return counter.cost, out, time.time() - t0


def run_cell(arch: str, shape: str, mesh_name: str = "h100",
             force: bool = False, overrides=None, tag: str = "",
             tcfg: TrainConfig = None, out_dir: str = RESULTS_DIR,
             rules=None) -> dict:
    out_path = _result_path(out_dir, mesh_name, arch, shape, tag)
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    cfg = get_config(arch, **(overrides or {}))
    chips = chips_of(mesh_name)
    mesh = rank_mesh(mesh_name)
    spec = SHAPES[shape]
    mf = model_flops(cfg, shape)
    result = {"arch": arch, "shape": shape, "mesh": mesh_name,
              "chips": chips, "mode": spec.mode, "model_flops_total": mf}
    t0 = time.time()
    try:
        with logical.use_rules(mesh, rules):
            fn, args, cfg = build_cell(cfg, shape, tcfg, mesh, rules)
            build_s = time.time() - t0
            cost, out, trace_s = count_step(fn, args, spec.mode == "train")
    except NotPorted as e:
        result.update(status="not_ported", reason=str(e))
    else:
        roof = rl.Roofline(
            flops_per_chip=cost.flops,
            bytes_per_chip=cost.bytes,
            coll_bytes_per_chip=cost.collective_bytes,
            chips=chips,
            model_flops_per_chip=mf / chips,
        )
        arg_bytes = tree_bytes(args)
        result.update({
            "status": "ok",
            "build_s": round(build_s, 2), "trace_s": round(trace_s, 2),
            "cost_analysis": {"flops": cost.flops,
                              "bytes accessed": cost.bytes},
            "memory": {
                "argument_bytes": arg_bytes,
                "output_bytes": tree_bytes(out),
                "temp_bytes": cost.temp_bytes,
                "code_bytes": None,
                "fits_one_card": (arg_bytes + cost.temp_bytes
                                  <= TARGET_CHIP.hbm_bytes),
            },
            "collective_bytes": rl.collective_bytes(cost.per_collective),
            "unparsed_loops": cost.unparsed_loops,
            "roofline": roof.as_dict(),
            "kernels": cost.kernels,
        })
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    return result


def _run_all(args):
    cells = [(arch, shape, mesh_name) for arch, shape in all_cells()
             for mesh_name in args.meshes]
    print(f"dry-run: {len(cells)} cells", flush=True)
    procs, failures, done = [], [], 0
    for arch, shape, mesh_name in cells:
        if os.path.exists(_result_path(args.out, mesh_name, arch, shape)) \
                and not args.force:
            done += 1
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh_name, "--out",
               args.out]
        if args.force:
            cmd.append("--force")
        procs.append(((arch, shape, mesh_name), subprocess.Popen(cmd)))
        while len(procs) >= args.jobs:
            procs, f, d = _reap(procs)
            failures += f
            done += d
            time.sleep(0.5)
    while procs:
        procs, f, d = _reap(procs)
        failures += f
        done += d
        time.sleep(0.5)
    print(f"dry-run complete: {done} ok, {len(failures)} failed")
    for cell in failures:
        print("  FAILED:", cell)
    return 1 if failures else 0


def _reap(procs):
    live, failures, done = [], [], 0
    for cell, p in procs:
        rc = p.poll()
        if rc is None:
            live.append((cell, p))
        elif rc == 0:
            done += 1
            print("  ok:", cell, flush=True)
        else:
            failures.append(cell)
            print("  FAIL:", cell, flush=True)
    return live, failures, done


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ALL_ARCHS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=tuple(MESHES), default="h100")
    ap.add_argument("--meshes", nargs="+", choices=tuple(MESHES),
                    default=list(MESHES), help="the meshes of --all")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--out", default=RESULTS_DIR,
                    help="results directory (one folder per mesh)")
    args = ap.parse_args(argv)

    if args.all:
        sys.exit(_run_all(args))

    if not (args.arch and args.shape):
        ap.error("--arch/--shape required unless --all")
    if not cell_applicable(args.arch, args.shape):
        print(f"SKIP (inapplicable): {args.arch} x {args.shape}")
        return
    try:
        r = run_cell(args.arch, args.shape, args.mesh, force=args.force,
                     out_dir=args.out)
    except Exception:
        traceback.print_exc()
        sys.exit(1)
    if r["status"] != "ok":
        print(f"{args.arch} x {args.shape} x {args.mesh}: {r['status']}: "
              f"{r['reason']}")
        return
    roof = r["roofline"]
    print(f"{args.arch} x {args.shape} x {args.mesh}: "
          f"trace={r['trace_s']}s "
          f"compute={roof['compute_s']:.2e}s memory={roof['memory_s']:.2e}s "
          f"collective={roof['collective_s']:.2e}s "
          f"dominant={roof['dominant']} "
          f"roofline_frac={roof['roofline_fraction']:.3f} "
          f"temp={r['memory']['temp_bytes']}")


if __name__ == "__main__":
    main()
