"""AdamW with fp32 master weights, global-norm clip, cosine schedule.

The optimizer state keeps fp32 master parameters alongside the moments so
models can train in bf16 compute precision.  The arithmetic is the
reference's, element for element and in its order, with the schedule and
the bias corrections in float32 tensors.  ``update`` writes the new
moments, master weights and parameters into the tensors it is given (the
reference's jitted step donates them the same way), one slice of each
leaf at a time, so that its temporaries stay small.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import tree

# elements of a leaf that ``update`` works on at once
_SLICE = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step):
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init(cfg: AdamWConfig, params):
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    # a copy: fp32 params must not alias the master
    return {
        "step": torch.zeros((), dtype=torch.int32,
                            device=tree.leaves(params)[0].device),
        "mu": tree.tree_map(zeros32, params),
        "nu": tree.tree_map(zeros32, params),
        "master": tree.tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params),
    }


def global_norm(leaves_or_tree, placement=None, specs=None):
    """The norm over every leaf.  Under a mesh (``placement``, a
    ``distributed.tensor_parallel.Placement``, and each leaf's spec) the
    leaves are this rank's shards: their squares are summed and
    all-reduced over the mesh, a leaf replicated over an axis counted
    once."""
    leaves = tree.leaves(leaves_or_tree)
    if placement is not None:
        return placement.global_norm(leaves, specs)
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves))


def _slices(x: torch.Tensor):
    """Views of ``x`` along its first axis, each of about ``_SLICE``
    elements; a 0-d tensor is one slice."""
    if x.dim() == 0:
        return [x]
    per = max(1, _SLICE // max(1, x[0].numel()))
    return [x[i:i + per] for i in range(0, x.shape[0], per)]


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state, params, placement=None,
           specs=None):
    """Returns (params, state, metrics): ``params`` and ``state`` are the
    tensors given, written in place (``state["step"]`` is replaced).
    Under a mesh every tree holds this rank's shards and the clipping
    norm is the whole gradient's (``global_norm``); the update is
    elementwise, so each rank updates its own shards."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    flat_g = tree.leaves(grads)
    gnorm = global_norm(flat_g, placement, specs)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)

    b1, b2 = cfg.beta1, cfg.beta2
    c1 = 1.0 - b1 ** step.to(torch.float32)
    c2 = 1.0 - b2 ** step.to(torch.float32)

    def leaf(g, mu, nu, master, p):
        decay = master.dim() >= 2                     # decay matrices only
        for g, mu, nu, master, p in zip(*map(_slices,
                                             (g, mu, nu, master, p))):
            g = g.to(torch.float32) * scale
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * torch.square(g))
            upd = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
            if decay:
                upd = upd + cfg.weight_decay * master
            master.sub_(lr * upd)
            p.copy_(master)

    for args in zip(flat_g, tree.leaves(state["mu"]), tree.leaves(state["nu"]),
                    tree.leaves(state["master"]), tree.leaves(params)):
        leaf(*args)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
