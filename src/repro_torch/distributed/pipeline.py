"""GPipe-style pipeline parallelism over a ``pp`` mesh axis.

Stages hold layer slices; microbatches stream through
``n_micro + n_stages - 1`` steps; bubbles = (stages-1)/(microbatches +
stages-1).  At each step every stage applies its layers to one microbatch
and passes its activation to the next stage (the reference's
"collective-permute pipeline", its ``ppermute`` here a point-to-point
pass over the axis's process group).  Layers are stacked (a leading layer
axis on every leaf), so a stage slice is a leading-axis slice.
"""

from __future__ import annotations

import torch

from repro_torch.core import tree
from repro_torch.distributed import collectives
from repro_torch.launch.mesh import Mesh


def stage_slice(stacked_params, n_stages: int, stage: int):
    """Slice layer-stacked params into one stage's sub-stack."""
    def one(x):
        per = x.shape[0] // n_stages
        return x[stage * per:(stage + 1) * per]
    return tree.tree_map(one, stacked_params)


def pipeline_apply(block_fn, stacked_params, x_microbatches: torch.Tensor,
                   mesh: Mesh, axis: str = "pp") -> torch.Tensor:
    """Run microbatches through pipeline stages, one stage a rank of
    ``axis``.

    block_fn(stage_params, x) -> x applies one stage's layer sub-stack.
    x_microbatches: (n_micro, mb, ...) activations, the same on every
    rank.  Returns (n_micro, mb, ...) outputs after all stages, on every
    rank of the axis (the last stage broadcasts them: the reference's
    closing ``psum`` of the last stage's outputs and zeros).  As in the
    reference, every stage runs ``block_fn`` at every step, on a bubble's
    placeholder too.
    """
    n_stages = mesh.shape[axis]
    stage, group = mesh.index(axis), mesh.group(axis)
    xs = x_microbatches
    n_micro = xs.shape[0]
    steps = n_micro + n_stages - 1
    params_stage = stage_slice(stacked_params, n_stages, stage)
    buf = torch.zeros_like(xs[0])
    outs = torch.zeros_like(xs)
    for t in range(steps):
        # Stage 0 injects microbatch t; others take the passed buf.
        x_in = xs[t if t < n_micro else 0] if stage == 0 else buf
        y = block_fn(params_stage, x_in)
        # Last stage emits a finished microbatch (t - n_stages + 1).
        done = t - (n_stages - 1)
        if stage == n_stages - 1 and done >= 0:
            outs[done] = y
        if t < steps - 1 and n_stages > 1:
            nxt = torch.empty_like(buf)
            collectives.exchange(y, nxt, (stage + 1) % n_stages,
                                 (stage - 1) % n_stages, group)()
            buf = nxt
    return collectives.broadcast(outs, n_stages - 1, group)


def pipeline_bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
