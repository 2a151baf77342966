"""End-to-end training run: train a ~100M-param llama-arch model for a few
hundred steps on the synthetic stream, with fault-tolerant checkpointing.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 300 [--small]
        [--device cpu]

The PyTorch port's counterpart of ``train_lm.py``.  ``--small`` shrinks
to smoke scale (seconds on CPU).  The default builds a genuine
~100M-parameter model (d=640, 10 layers, 32k vocab) and runs the full
production loop: seeded init on the device, the train step, async
checkpoints, straggler watchdog, resume-on-restart.  Every projection,
forward and backward, runs on the CUDA fused-matmul kernel (its autograd
op); attention and the loss on plain tensor ops, as ``launch/train.py``
trains.  Runs on the CUDA card; ``--device cpu`` runs the kernel's plain
version on the CPU instead, and without a card and without ``--device``
it stops with an error.
"""

import argparse
import dataclasses
import os
import sys
import tempfile
import time
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.precision import disable_tf32
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.serve import resolve_device
from repro_torch.models.base import family_module
from repro_torch.optim import adamw
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.watchdog import StepWatchdog
from repro_torch.training.train_step import TrainConfig, make_train_step


def build_config(small: bool):
    # llama-arch family wiring; attention and the loss on the plain route
    base = get_config("yi-6b").with_(backend="torch")
    if small:
        return base.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab_size=512,
                          dtype=torch.float32, remat="none", attn_chunk=64)
    return base.with_(n_layers=10, d_model=640, n_heads=10, n_kv_heads=5,
                      head_dim=64, d_ff=1920, vocab_size=32000,
                      dtype=torch.float32, remat="none", attn_chunk=256)


@dataclasses.dataclass
class TrainRun:
    start: int                    # the step it resumed from (0: fresh)
    losses: "list[float]"         # one a step taken
    step_ms: "list[float]"        # host ms a step, the loss read back
    steps: "list[int]"            # the checkpoints on disk at the end
    params: dict
    opt: dict


def train(cfg, *, steps: int, global_batch: int, seq_len: int,
          ckpt_dir: str, device, params=None, ckpt_every: int = 100,
          until: "int | None" = None) -> TrainRun:
    """Train ``cfg`` to ``steps`` on ``device``, resuming from the latest
    checkpoint in ``ckpt_dir`` if there is one; ``params`` (else seeded
    from 0 on ``device``) start a fresh run.  An async checkpoint is
    written every ``ckpt_every`` steps.  ``until`` stops the run after
    that many steps of the schedule that ``steps`` sets."""
    mod = family_module(cfg)
    tcfg = TrainConfig(
        optimizer=adamw.AdamWConfig(lr=3e-3, total_steps=steps,
                                    warmup_steps=max(steps // 20, 1)),
        loss_chunk=min(256, seq_len))
    step_fn = make_train_step(cfg, tcfg)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  global_batch=global_batch,
                                  seq_len=seq_len), device=device)
    mgr = CheckpointManager(ckpt_dir, keep=2)
    wd = StepWatchdog()

    if params is None:
        params = mod.init(cfg, torch.Generator(device=device).manual_seed(0),
                          device)
    opt = adamw.init(tcfg.optimizer, params)
    start = 0
    if mgr.latest_step() is not None:
        # the step updates its state in place: restore into fresh tensors
        restored, extra = mgr.restore(mgr.latest_step(),
                                      {"params": params, "opt": opt},
                                      device=device)
        del params, opt
        params, opt = restored["params"], restored["opt"]
        data.load_state_dict(extra["data"])
        start = extra["step"]
        print(f"resumed from step {start}")

    losses, step_ms = [], []
    try:
        for step in range(start, steps if until is None else until):
            t0 = time.perf_counter()
            params, opt, metrics, _ = step_fn(params, opt, next(data))
            loss = float(metrics["loss"])             # waits for the step
            dt = time.perf_counter() - t0
            wd.record_step(dt)
            losses.append(loss)
            step_ms.append(dt * 1e3)
            if step % 20 == 0:
                print(f"step {step:4d}  loss {loss:.4f}  "
                      f"lr {float(metrics['lr']):.2e}  "
                      f"{dt * 1e3:.0f} ms", flush=True)
            if (step + 1) % ckpt_every == 0:
                mgr.save_async(step + 1, {"params": params, "opt": opt},
                               extra={"data": data.state_dict(),
                                      "step": step + 1})
        mgr.wait()
    finally:
        wd.close()
    return TrainRun(start, losses, step_ms, mgr.all_steps(), params, opt)


def arguments(argv=None):
    """The command line, parsed: its defaults are the run's sizes."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train_lm"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, required)")
    return ap.parse_args(argv)


def main(argv=None):
    args = arguments(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        disable_tf32()

    cfg = build_config(args.small)
    if args.small:
        args.seq_len = min(args.seq_len, 64)
    print(f"model: {cfg.param_count() / 1e6:.1f}M params "
          f"({cfg.n_layers}L d={cfg.d_model} vocab={cfg.padded_vocab})")
    run = train(cfg, steps=args.steps, global_batch=args.global_batch,
                seq_len=args.seq_len, ckpt_dir=args.ckpt_dir, device=device)
    if run.losses:
        print(f"final loss {run.losses[-1]:.4f} (started "
              f"{run.losses[0]:.4f}); checkpoints at {args.ckpt_dir}: "
              f"steps {run.steps}")
    return run


if __name__ == "__main__":
    main()
