"""Collective matmul: overlap an all-gather with the matmul that consumes it.

Instead of ``all_gather(x) @ w`` (link idle during compute, tensor cores
idle during the gather), walk the ring: each rank multiplies the X shard
it holds while the shard passes to the next rank, so compute and
communication pipeline at shard granularity (Wang et al., "Overlap
communication with dependent computation").  The reference writes the
ring as ``ppermute`` inside ``shard_map``; here it is
``batch_isend_irecv`` over the axis's process group
(``collectives.exchange``) around one K1 launch a step.
"""

from __future__ import annotations

import torch

from repro_torch.core.fusion import Epilogue, cute_matmul
from repro_torch.distributed import collectives
from repro_torch.launch.mesh import Mesh


def _out_dtype(x: torch.Tensor) -> torch.dtype:
    """x's dtype, as the reference's ``preferred_element_type=x.dtype``;
    int32 (K1's accumulator) for int8 inputs."""
    return torch.int32 if x.dtype == torch.int8 else x.dtype


def _ring_matmul(x_shard, w_shard, group, n_dev: int) -> torch.Tensor:
    """x_shard: (m_local, k), this rank's rows of X; w_shard: (k,
    n_local), its columns of W.  Returns ``all_gather(x) @ w_shard``,
    (m_local · n_dev, n_local).

    At step i the rank holds the shard of rank ``(idx - i) % n_dev`` and
    writes its product at that shard's rows, while the shard passes on to
    rank ``idx + 1`` (and the next one arrives from ``idx - 1``).  The
    reference passes the shard once more after the last step, which brings
    it back to its owner and is not used; that pass is left out.
    """
    idx = torch.distributed.get_rank(group)
    m_local = x_shard.shape[0]
    ep = Epilogue(out_dtype=_out_dtype(x_shard))
    out = torch.empty((m_local * n_dev, w_shard.shape[1]),
                      dtype=ep.out_dtype, device=x_shard.device)
    x, buf = x_shard.contiguous(), torch.empty_like(x_shard)
    for i in range(n_dev):
        src = (idx - i) % n_dev                   # whose shard we hold now
        wait = (collectives.exchange(x, buf, (idx + 1) % n_dev,
                                     (idx - 1) % n_dev, group)
                if i < n_dev - 1 else None)
        out[src * m_local:(src + 1) * m_local] = cute_matmul(
            x, w_shard, epilogue=ep, backend="kernel")   # overlaps the pass
        if wait is not None:
            wait()
            x, buf = buf, x
    return out


def collective_matmul(x, w, mesh: Mesh, axis: str = "model"):
    """x: (M, K), w: (K, N), whole on every rank; X is taken in row
    shards and W in column shards over ``axis``.  Returns this rank's
    (M, N / n) column block of ``x @ w`` as a DTensor, sharded on N over
    ``axis`` and replicated over the mesh's other axes (the reference's
    ``out_specs=P(None, axis)``); X is gathered by the ring, overlapped.
    """
    from torch.distributed.tensor import DTensor, Replicate, Shard
    n_dev, idx = mesh.shape[axis], mesh.index(axis)
    m, n = x.shape[0], w.shape[1]
    if m % n_dev or n % n_dev:
        raise ValueError(f"({m}, {n}) does not split over {n_dev} ranks")
    rows, cols = m // n_dev, n // n_dev
    out = _ring_matmul(x[idx * rows:(idx + 1) * rows],
                       w[:, idx * cols:(idx + 1) * cols].contiguous(),
                       mesh.group(axis), n_dev)
    placements = [Shard(1) if a == axis else Replicate()
                  for a in mesh.axis_names]
    return DTensor.from_local(out, mesh.device_mesh, placements,
                              run_check=False)


def allgather_matmul_reference(x, w):
    """The unoverlapped equivalent (numerical oracle), in plain tensor
    ops: fp32 (int32 for int8) accumulation, cast to x's dtype."""
    return cute_matmul(x, w, epilogue=Epilogue(out_dtype=_out_dtype(x)),
                       backend="torch")
