"""Training step factory: microbatched, remat'd, compression-optional.

``make_train_step(cfg, tcfg)`` builds a (params, opt_state, batch,
residual) → (params, opt_state, metrics, residual) function.  Gradients
come from ``torch.autograd.grad`` over the parameter leaves; with
microbatches (sliced along the batch axis) they accumulate in fp32, so
the activation working set is 1/N of the global batch.  As the
reference's jitted step donates its buffers, the step writes the new
parameters and optimizer state into the tensors it is given.

Under a mesh this process is a rank of (the active ``logical`` rules,
``distributed.tensor_parallel``), ``params`` and ``opt_state`` are the
rank's shards (``sharding.shard_params``) and ``batch`` its rows of each
microbatch (``sharding.local_batch``).  The loss is the rank's share of
the global microbatch's mean; FSDP leaves' gradients are reduce-scattered
in the backward, every other leaf's all-reduced over the batch axes its
spec does not name; the clipping norm counts each leaf once; the loss
returned is the global one.

Every family trains, as in the reference, on the ``torch`` and ``dense``
routes (``cfg.backend``): the reference never differentiates its Pallas
kernels, and on the ``torch`` route MoE's experts, the RG-LRU and the WKV
run as plain ops that autograd differentiates, while every projection
stays on the zoo's matmul route (K1 through its autograd op).  On the
``kernel`` route K2, K4, K5 and K6 refuse autograd (``NotPorted``).
Whisper's batch carries ``audio_embeds`` beside the tokens.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core import hlo_cost, tree
from repro_torch.distributed import sharding
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models.base import ArchConfig, family_module
from repro_torch.optim import adamw, compression
from repro_torch.training import loss as loss_lib


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: adamw.AdamWConfig = adamw.AdamWConfig()
    microbatches: int = 1
    z_loss: float = 1e-4
    loss_chunk: int = 512
    grad_compression: bool = False
    ce_onehot_pick: bool = False     # vocab-sharded CE without the gather


def _loss_fn(cfg: ArchConfig, tcfg: TrainConfig, params, batch):
    mod = family_module(cfg)
    labels = loss_lib.shift_labels(cfg, batch["tokens"], batch["labels"])
    hidden = mod.forward(cfg, params, batch, return_hidden=True)
    loss, metrics = loss_lib.chunked_softmax_xent(
        cfg, params, hidden, labels, chunk=tcfg.loss_chunk,
        z_loss=tcfg.z_loss, onehot_pick=tcfg.ce_onehot_pick)
    return loss, metrics


def value_and_grad(cfg: ArchConfig, tcfg: TrainConfig, params, batch):
    """(loss, metrics, grads): the reference's ``jax.value_and_grad`` of
    ``_loss_fn``.  ``grads`` has the structure of ``params`` and their
    dtypes; ``params`` themselves are left as they are (the gradient is
    taken at leaves that alias them)."""
    flat = tree.leaves(params)
    live = [p.detach().requires_grad_() for p in flat]
    with torch.enable_grad():
        loss, metrics = _loss_fn(cfg, tcfg, tree.unflatten(params, live),
                                 batch)
        # a leaf the loss does not reach gets zeros, as in JAX
        grads = torch.autograd.grad(loss, live, allow_unused=True,
                                    materialize_grads=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree.unflatten(params, list(grads))


def _split_microbatch(batch, n: int, i: int):
    def slice_one(x):
        mb = x.shape[0] // n
        return x[i * mb:(i + 1) * mb]
    return {k: slice_one(v) for k, v in batch.items()}


def leaf_specs(cfg: ArchConfig, params, mesh):
    """Each leaf's spec under the active rules of ``mesh``, in tree order,
    from the whole shapes; raises where a leaf of ``params`` is not the
    rank's shard under them.  The whole tree is built on ``meta``,
    outside any cost count."""
    with hlo_cost.quiet():
        whole = family_module(cfg).init(cfg, None, "meta")
    specs = sharding.param_specs(whole)
    for (path, x), w, spec in zip(tree.flatten_with_path(params),
                                  tree.leaves(whole), specs):
        want = sharding.local_shape(mesh, w.shape, spec)
        if tuple(x.shape) != want:
            raise ValueError(f"{path}: a leaf of {tuple(x.shape)} where the "
                             f"rank's shard of {tuple(w.shape)} under the "
                             f"rules is {want}")
    return specs


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig = TrainConfig()):
    grad_fn = functools.partial(value_and_grad, cfg, tcfg)
    specs_of: dict = {}

    def train_step(params, opt_state, batch, residual=None):
        pl = tp.current()
        specs = None
        if pl is not None:
            key = id(pl)
            if key not in specs_of:
                specs_of.clear()
                specs_of[key] = (pl, leaf_specs(cfg, params, pl.mesh))
            specs = specs_of[key][1]
        n = tcfg.microbatches
        if n == 1:
            loss, metrics, grads = grad_fn(params, batch)
        else:
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in tree.leaves(params)]
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=acc[0].device)
            for i in range(n):
                l, _, g = grad_fn(params, _split_microbatch(batch, n, i))
                for a, gi in zip(acc, tree.leaves(g)):
                    a.add_(gi)
                del g
                loss_sum = loss_sum + l
            for a in acc:
                a.div_(n)
            grads = tree.unflatten(params, acc)
            loss = loss_sum / n
            metrics = {}

        if pl is not None:
            with torch.no_grad():
                pl.reduce_gradients(tree.leaves(grads), specs)
                loss = pl.sum_over_batch(loss.clone())
                metrics = {k: pl.sum_over_batch(v.clone()) if k != "tokens"
                           else v for k, v in metrics.items()}
        if tcfg.grad_compression and residual is not None:
            grads, residual = compression.compressed_gradients(grads,
                                                               residual)
        params, opt_state, opt_metrics = adamw.update(
            tcfg.optimizer, grads, opt_state, params, pl, specs)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics, residual

    return train_step


def abstract_state(cfg: ArchConfig, tcfg: TrainConfig):
    """(params, opt_state) on the ``meta`` device: shapes and dtypes, no
    memory."""
    params = family_module(cfg).init(cfg, None, "meta")
    return params, adamw.init(tcfg.optimizer, params)
