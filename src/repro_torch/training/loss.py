"""Cross-entropy with sequence-chunked logits (fused-CE memory saver).

Materialising (B, S, V) logits for a 256k vocabulary at 4k context is the
single biggest activation in training.  The chunked form walks the
sequence, computing logits → log-softmax → NLL one chunk at a time, and
recomputes each chunk's logits in the backward
(``torch.utils.checkpoint``, as the reference's ``jax.checkpoint`` per
chunk), so the live buffer is (B, chunk, V).  Soft-capping (gemma2)
happens inside the chunk.  Labels < 0 are masked (padding /
vision-prefix positions).  Optional z-loss regularises the partition
function (PaLM-style).

The logits are fp32 from fp32 accumulation, as the reference's
``preferred_element_type=jnp.float32`` makes them: the logits call goes
through ``linear`` with an fp32 output on the zoo's matmul route (K1
through its autograd op, its softcap fused in the epilogue, or the
plain route on fp32-cast operands).

Under a mesh this process is a rank of (``distributed.tensor_parallel``)
the loss is vocab-parallel: each rank's logits are its vocabulary
columns, and the row max, the sum of exponentials and the label's logit
are each reduced over ``model`` (``_chunk_ce_placed``).  The token count
is summed over the batch axes, so that a rank's loss is its share of the
global microbatch's mean and the ranks' gradients sum to the reference's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.backend import matmul_backend_string
from repro_torch.core.fusion import linear
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models.base import ArchConfig


def _chunk_ce(x, w, labels, softcap: float, z_loss: float,
              onehot_pick: bool = False):
    """x: (B, C, d); w: (d, V); labels: (B, C) -> (sum_nll, sum_z, n_valid).

    ``onehot_pick`` selects the label logit with a one-hot contraction
    instead of a gather, as the reference does for a vocab-sharded layout;
    it gives the same number.
    """
    logits = linear(x, w, softcap=softcap, out_dtype=torch.float32,
                    backend=matmul_backend_string())
    lse = torch.logsumexp(logits, dim=-1)                     # (B, C)
    valid = labels >= 0
    safe = labels.clamp(min=0).long()
    if onehot_pick:
        onehot = F.one_hot(safe, logits.shape[-1]).to(logits.dtype)
        picked = torch.einsum("bcv,bcv->bc", logits, onehot)
    else:
        picked = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, lse - picked, 0.0)
    z = torch.where(valid, torch.square(lse), 0.0)
    return (torch.sum(nll), z_loss * torch.sum(z),
            torch.sum(valid.to(torch.float32)))


def _chunk_ce_placed(pl, x, w, labels, softcap: float, z_loss: float,
                     onehot_pick: bool = False):
    """``_chunk_ce`` on the rank's vocabulary columns ``w`` (d, V/m): the
    logsumexp from the all-reduced row max and sum of exponentials, the
    label's logit from the rank that holds it."""
    logits = linear(x, w, softcap=softcap, out_dtype=torch.float32,
                    backend=matmul_backend_string())
    row_max = pl.reduce_max(logits.amax(dim=-1))
    total = pl.reduce(torch.sum(torch.exp(logits - row_max[..., None]), -1))
    lse = row_max + torch.log(total)
    valid = labels >= 0
    n = logits.shape[-1]
    local = labels.long() - pl.rank * n
    hit = valid & (local >= 0) & (local < n)
    safe = torch.where(hit, local, 0)
    if onehot_pick:
        onehot = F.one_hot(safe, n).to(logits.dtype) * hit[..., None]
        picked = torch.einsum("bcv,bcv->bc", logits, onehot)
    else:
        picked = torch.where(
            hit, torch.gather(logits, -1, safe[..., None])[..., 0], 0.0)
    picked = pl.reduce(picked)
    nll = torch.where(valid, lse - picked, 0.0)
    z = torch.where(valid, torch.square(lse), 0.0)
    return (torch.sum(nll), z_loss * torch.sum(z),
            torch.sum(valid.to(torch.float32)))


def chunked_softmax_xent(cfg: ArchConfig, params, hidden, labels, *,
                         chunk: int = 512, z_loss: float = 1e-4,
                         onehot_pick: bool = False):
    """hidden: (B, S, d); labels: (B, S) with -1 = masked.  Under a mesh,
    ``hidden`` holds the rank's share of the sequence where the forward's
    pass shards it (sequence parallelism): it is gathered first, into the
    vocabulary-parallel region, or, where the output weight is whole,
    for every rank to compute the whole loss (its gradient the rank's
    share, ``Placement.gather_stream``)."""
    from repro_torch.models.common import output_weight
    pl = tp.current()
    w, split = output_weight(cfg, params, pl)
    if split:
        hidden = pl.enter(hidden)
    elif pl is not None:
        hidden = pl.gather_stream(hidden)
    b, s, d = hidden.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    n = (s + pad) // chunk
    xs = hidden.reshape(b, n, chunk, d).unbind(1)
    ls = labels.reshape(b, n, chunk).unbind(1)

    def body(x_c, l_c):
        if split:
            return _chunk_ce_placed(pl, x_c, w, l_c, cfg.final_softcap,
                                    z_loss, onehot_pick)
        return _chunk_ce(x_c, w, l_c, cfg.final_softcap, z_loss, onehot_pick)

    zero = torch.zeros((), dtype=torch.float32, device=hidden.device)
    nll, z, cnt = zero, zero, zero
    for x_c, l_c in zip(xs, ls):
        # Remat per chunk: backward recomputes the chunk's logits rather
        # than storing (B, chunk, V) residuals for every chunk.
        if torch.is_grad_enabled() and (x_c.requires_grad or w.requires_grad):
            out = checkpoint(body, x_c, l_c, use_reentrant=False)
        else:
            out = body(x_c, l_c)
        nll, z, cnt = nll + out[0], z + out[1], cnt + out[2]
    if pl is not None:
        cnt = pl.sum_over_batch(cnt.detach().clone())
    cnt = torch.clamp(cnt, min=1.0)
    return (nll + z) / cnt, {"nll": nll / cnt, "z": z / cnt, "tokens": cnt}


def shift_labels(cfg: ArchConfig, tokens, labels):
    """Mask out positions the model cannot predict (vision prefix)."""
    if cfg.vision_prefix:
        labels = labels.clone()
        labels[:, : cfg.vision_prefix] = -1
    return labels
