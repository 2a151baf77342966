"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \\
        --reduced --device cpu --steps 200 --global-batch 8 --seq-len 128 \\
        --ckpt-dir /tmp/run1

Production shape: config → state → fault-tolerant loop (async
checkpoints, straggler watchdog, preemption handler, auto-resume with the
data stream's state), the reference launcher's flags and loop.  Runs on
the CUDA card; ``--device cpu`` runs the kernels' plain versions on the
CPU instead, and without ``--device`` and without a card it stops with an
error.

Every family trains.  Every projection runs on the zoo's matmul route
(K1 through its autograd Function by default); the rest trains on the
plain ``torch`` route (``cfg.backend = "torch"``: chunked attention,
MoE's expert einsums, the RG-LRU and the WKV in tensor ops), the
counterpart of the reference's ``xla`` route, since K2, K4, K5 and K6
have no backward.  The stream (``data/pipeline.py::SyntheticLM``) holds
tokens and labels only, as the reference's does: an encoder-decoder
model (Whisper), whose batch needs ``audio_embeds``, is refused up front
(the reference's launcher fails on it mid-step); it trains through
``training.train_step.make_train_step`` on a batch that carries them.

On a mesh, as the reference's launcher: ``--mesh host --model-parallel
m`` lays (world / m, m) over (data, model) across the running world
(``torchrun``'s environment through ``launch.mesh.init_world``, or a
world already joined, as ``launch.mesh.run_world`` joins one); ``--mesh
single`` and ``multi`` need a world of 256 and 512 ranks.  Without a
world the run is one process, and ``--model-parallel`` has nothing to
split (the reference's ``make_host_mesh`` on one device).  Every rank
seeds the whole model, keeps its shards under the default rules
(``distributed.sharding.shard_params``: FSDP over data, Megatron tensor
parallelism over model) and takes its rows of each microbatch; every
family the launcher trains does so (the dense and MoE families,
RecurrentGemma and RWKV-6).  Checkpoints hold the
whole leaves in the reference's layout (rank 0 writes, one leaf gathered
at a time), so a one-process run resumes them and any mesh restores
them::

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh host \\
        --model-parallel 2 --reduced --device cpu --steps 4

``main(argv)`` parses the flags and builds the configuration;
``train(cfg, args)`` runs the loop for any configuration (a full-width
one cut in depth, say) and returns what it did.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch
import torch.distributed as dist

from repro_torch.backend import default_matmul_backend
from repro_torch.configs.registry import ALL_ARCHS, get_config
from repro_torch.core import tree
from repro_torch.core.precision import disable_tf32
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.distributed import logical, sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.serve import resolve_device
from repro_torch.models.base import ArchConfig, family_module
from repro_torch.optim import adamw
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.watchdog import PreemptionHandler, StepWatchdog
from repro_torch.training.train_step import TrainConfig, make_train_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ALL_ARCHS, default="yi-6b")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", choices=("host", "single", "multi"),
                    default="host")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, required)")
    return ap.parse_args(argv)


@dataclasses.dataclass
class TrainResult:
    params: dict
    opt_state: dict
    start: int                   # the step the loop began at (resume)
    losses: "list[float]"        # one per step run
    step_seconds: "list[float]"  # host clock, each ending in a sync
    step_ms_device: "list[float]"  # CUDA events on a card, else empty


#: ranks of the reference's pod meshes
POD_RANKS = {"single": 256, "multi": 512}


def _world_size() -> int:
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _check_mesh(args) -> None:
    """Stop up front when ``--mesh`` asks for a world that is not there."""
    need = POD_RANKS.get(args.mesh)
    if need is not None and _world_size() != need:
        raise SystemExit(f"--mesh {args.mesh} needs a world of {need} ranks "
                         f"(the {'2 x ' if args.mesh == 'multi' else ''}"
                         f"16 x 16 mesh); this one has {_world_size()}")
    if args.model_parallel < 1:
        raise SystemExit(f"--model-parallel {args.model_parallel}: at "
                         "least 1")


def _mesh(args, device):
    """The run's mesh: None for one process (a world of one rank)."""
    if not dist.is_initialized() and _world_size() > 1:
        mesh_lib.init_world(device)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    if args.mesh == "host":
        return mesh_lib.make_host_mesh(model=args.model_parallel)
    return mesh_lib.make_production_mesh(multi_pod=args.mesh == "multi")


def train_config(args) -> TrainConfig:
    """The step's configuration under the launcher's flags."""
    return TrainConfig(
        optimizer=adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                                    warmup_steps=max(args.steps // 20, 1)),
        microbatches=args.microbatches,
        grad_compression=args.grad_compression,
        loss_chunk=min(512, args.seq_len))


def _check_stream(cfg: ArchConfig) -> None:
    if cfg.encdec is not None:
        raise ValueError(
            f"{cfg.name}: the launcher's stream holds tokens and labels "
            "only, and an encoder-decoder step needs audio_embeds (the "
            "reference's launcher cannot train it either: ROADMAP queue 3, "
            "reference caveats); train it through "
            "training.train_step.make_train_step on a batch that carries "
            "them")


def train(cfg: ArchConfig, args) -> TrainResult:
    """The training loop of ``cfg`` under ``args`` (``parse_args``'s)."""
    _check_mesh(args)
    _check_stream(cfg)
    device = resolve_device(args.device)
    if device.type == "cuda":
        disable_tf32()
    mesh = _mesh(args, device)
    with logical.use_rules(mesh):
        return _train(cfg, args, device, mesh)


def _train(cfg: ArchConfig, args, device, mesh) -> TrainResult:
    # the reference trains on its xla route: the plain torch route here
    # (attention, experts, recurrences); the projections stay on the zoo's
    # matmul route
    cfg = cfg.with_(backend="torch")
    mod = family_module(cfg)
    tcfg = train_config(args)
    step_fn = make_train_step(cfg, tcfg)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  global_batch=args.global_batch,
                                  seq_len=args.seq_len), device=device)
    writer = mesh is None or dist.get_rank() == 0
    mgr = (CheckpointManager(args.ckpt_dir, writer=writer)
           if args.ckpt_dir else None)
    watchdog = StepWatchdog()
    preempt = PreemptionHandler()
    where = "" if mesh is None else (
        f", rank {dist.get_rank()} of {mesh!r} at {mesh.coordinate}")
    print(f"[train] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"{str(cfg.dtype)[6:]}, remat={cfg.remat}, on {device}{where}; "
          f"{cfg.family} on the plain route (backend=torch, as the "
          f"reference trains on xla), projections on the "
          f"{default_matmul_backend()!r} matmul route", flush=True)

    params = mod.init(cfg, torch.Generator(device=device).manual_seed(0),
                      device)
    whole = None
    if mesh is not None:
        params = sharding.shard_params(params, mesh, glu=cfg.mlp_glu)
        like = {"params": mod.init(cfg, None, "meta")}
        like["opt"] = adamw.init(tcfg.optimizer, like["params"])

        def whole(state, fn):
            sharding.gather_params(state, like, mesh, leaf_fn=fn,
                                   glu=cfg.mlp_glu)
    opt = adamw.init(tcfg.optimizer, params)
    residual = None
    start = 0
    if mgr and mgr.latest_step() is not None:
        restored, extra = mgr.restore(
            mgr.latest_step(), {"params": params, "opt": opt},
            device="cpu" if mesh is not None else device)
        del params, opt
        if mesh is not None:
            restored = tree.tree_map(lambda x: x.to(device),
                                     sharding.shard_params(
                                         restored, mesh, glu=cfg.mlp_glu))
        params, opt = restored["params"], restored["opt"]
        data.load_state_dict(extra["data"])
        start = extra["train_step"]
        print(f"resumed from step {start}")

    losses, seconds, device_ms = [], [], []
    timed = device.type == "cuda"
    try:
        for step in range(start, args.steps):
            t0 = time.perf_counter()
            if timed:
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                ev0.record()
            batch = next(data)
            if mesh is not None:
                batch = sharding.local_batch(batch, mesh, args.microbatches)
            params, opt, metrics, residual = step_fn(params, opt, batch,
                                                     residual)
            if timed:
                ev1.record()
            loss = float(metrics["loss"])             # waits for the step
            dt = time.perf_counter() - t0
            losses.append(loss)
            seconds.append(dt)
            if timed:
                device_ms.append(ev0.elapsed_time(ev1))
            slow = watchdog.record_step(dt)
            if writer and (step % args.log_every == 0 or slow):
                tag = " STRAGGLER" if slow else ""
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"{dt * 1e3:.0f}ms{tag}", flush=True)
            want_ckpt = mgr and ((step + 1) % args.ckpt_every == 0
                                 or preempt.requested)
            if want_ckpt:
                mgr.save_async(step + 1, {"params": params, "opt": opt},
                               extra={"data": data.state_dict(),
                                      "train_step": step + 1}, whole=whole)
            if preempt.requested:
                print("preemption requested: checkpointed, exiting")
                break
        if mgr:
            mgr.wait()
    finally:
        watchdog.close()
        preempt.restore()
    print(f"done: {watchdog.steps} steps, "
          f"{watchdog.straggler_events} straggler events")
    return TrainResult(params, opt, start, losses, seconds, device_ms)


def main(argv=None) -> TrainResult:
    args = parse_args(argv)
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.reduced:
        cfg = cfg.with_(dtype=torch.float32, remat="none")
    return train(cfg, args)


if __name__ == "__main__":
    main()
