"""Int8 error-feedback gradient compression (distributed-optimization).

Before the data-parallel all-reduce, gradients are quantized to int8 with
a per-tensor scale; the quantization error is kept in a local residual
buffer and added back next step (error feedback — 1-bit-Adam lineage).
Collective volume drops 4× (fp32) / 2× (bf16); convergence is preserved
by the residual.

This wraps the *gradient tree*: ``compressed_gradients`` quantizes and
dequantizes around an all-reduce made elsewhere, and ``psum_compressed``
all-reduces the int8 payloads themselves over a process group.
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

import torch

from repro_torch.core import tree


def init_residual(params):
    return tree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def _quant(x):
    absmax = torch.max(torch.abs(x))
    scale = torch.where(absmax == 0, 1.0, absmax / 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_tree(grads, residual):
    """Returns (q_tree, scale_tree, new_residual)."""
    def one(g, r):
        x = g.to(torch.float32) + r
        q, scale = _quant(x)
        deq = q.to(torch.float32) * scale
        return q, scale, x - deq
    out = [one(g, r) for g, r in zip(tree.leaves(grads),
                                     tree.leaves(residual))]
    return tuple(tree.unflatten(grads, [o[i] for o in out])
                 for i in range(3))


def decompress_tree(q_tree, scale_tree):
    return tree.tree_map(lambda q, s: q.to(torch.float32) * s,
                         q_tree, scale_tree)


def compressed_gradients(grads, residual):
    """Quantize→dequantize with error feedback."""
    q, s, new_res = compress_tree(grads, residual)
    return decompress_tree(q, s), new_res


def psum_compressed(grads, residual, group=None):
    """All-reduce the int8 payloads over ``group`` (the world by
    default): each leaf's payload summed as int32, then scaled by this
    rank's scale and divided by the group's size, as the reference's
    ``psum_compressed`` does under ``shard_map``.  Returns (averaged
    gradients, new residual)."""
    import torch.distributed as dist

    from repro_torch.distributed import collectives
    q, s, new_res = compress_tree(grads, residual)
    summed = tree.tree_map(
        lambda qq: collectives.all_reduce(qq.to(torch.int32), group), q)
    n = dist.get_world_size(group)
    avg = tree.tree_map(lambda acc, ss: acc.to(torch.float32) * ss / n,
                        summed, s)
    return avg, new_res
