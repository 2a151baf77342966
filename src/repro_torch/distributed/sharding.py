"""Parameter / batch / cache sharding rules (divisibility-aware), their
placement as DTensors, and the cluster-partitioned GEMM.

Maps every parameter leaf to logical axes by its name, then through the
active ``logical`` rules to a ``NamedSharding`` (a spec on a mesh).
Megatron-style TP falls out of the name map: QKV and MLP-in shard their
*output* column (column parallel), attention-out and MLP-out shard their
*input* row (row parallel).  Trees are walked in JAX's order over the
port's paths (``core.tree``), so leaf i here is leaf i of the reference.

``apply_shardings`` places each leaf with ``distribute_tensor``: every
rank holds the whole leaf (seeded weights, a restored checkpoint) and
keeps its own shard, with no communication.  An expert-parallel served
model shards its experts only (``EXPERT_PARALLEL_RULES``); every other
leaf stays whole on each rank.

``shard_params`` keeps each rank's shard as a plain tensor, the form the
models run on under a mesh (``tensor_parallel``), and ``gather_params``
is its inverse, a tree back in the reference's layout (checkpoints,
tests).  They differ from the DTensor placement in one leaf: the GLU
input projection ``wi`` (d, 2·d_ff) holds the gate in its first half and
the up projection in its second, and K1 reads it as (d, 2, d_ff/...).  A
contiguous column shard would give rank 0 only gates, so a rank's shard
of ``wi`` is ``wi.view(d, 2, d_ff)[:, :, r·d_ff/m:(r+1)·d_ff/m]``: the
same size as the reference's shard, its gate and up columns paired
(where each half splits over the ranks: else the reference's contiguous
shard, ``glu_paired``, which the blocks gather whole).
The experts' input projection ``experts_wi`` (E, d, 2·ff) is paired the
same way where a rule splits its ``mlp_expert`` dim (GSPMD expert
parallelism, ``models/moe.py``).  Only a GLU's ``wi`` and ``experts_wi``
are paired: the callers pass the config's ``mlp_glu``, and a plain MLP's
``wi`` (Whisper's GELU projection) takes the reference's contiguous
column shard.
``local_batch`` gives a rank its rows of each microbatch and
``shard_cache`` its KV cache shard, in each of the reference's three
forms (``gather_cache`` is its inverse).
"""

from __future__ import annotations

from typing import Optional

import torch

import math

from repro_torch.core import tree
from repro_torch.distributed import logical
from repro_torch.distributed.logical import NamedSharding
from repro_torch.launch.mesh import Mesh

#: leaf name -> logical axes (matched on the last path component).
_NAME_RULES: "dict[str, tuple]" = {
    "embedding": ("vocab", "embed"),
    "lm_head": ("embed", "vocab"),
    "wq": ("embed", "heads"),        # column parallel
    "wk": ("embed", "kv_heads"),
    "wv": ("embed", "kv_heads"),
    "wo": ("heads", "embed"),        # row parallel
    "wi": ("embed", "mlp"),          # column parallel (GLU keeps 2x cols)
    "w_router": ("embed", None),     # replicated router
    "experts_wi": ("experts", "embed", "mlp_expert"),
    "experts_wo": ("experts", "mlp_expert", "embed"),
    # Griffin recurrent block.
    "w_rnn_in": ("embed", "mlp"),
    "w_gate_in": ("embed", "mlp"),
    "w_rnn_out": ("mlp", "embed"),
    # RWKV time-mix projections.
    "w_r": ("embed", "heads"),
    "w_k": ("embed", "heads"),
    "w_v": ("embed", "heads"),
    "w_g": ("embed", "heads"),
    "w_o": ("heads", "embed"),
    "w_cm_k": ("embed", "mlp"),
    "w_cm_v": ("mlp", "embed"),
    "w_cm_r": ("embed", "mlp"),
}
# mlp wo: name collision with attention wo is fine — both are row parallel
# with the sharded dim first.

#: the leaves whose last dim is a GLU's (gate | up) under ``mlp_glu``
GLU_LEAVES = ("wi", "experts_wi")

#: rules that shard the experts over ``model`` and keep every other leaf
#: whole: the placement of an expert-parallel served model, whose dense
#: layers run whole on each rank (``models/moe.py::moe_apply``)
EXPERT_PARALLEL_RULES = {"embed": None, "heads": None, "kv_heads": None,
                         "mlp": None, "vocab": None}


def _leaf_name(path) -> "str | None":
    return next((p for p in reversed(path) if isinstance(p, str)), None)


def leaf_axes(name: "str | None", ndim: int) -> "tuple | None":
    """The logical axes of a leaf called ``name`` with ``ndim`` dims (a
    stacked leaf's leading layer dims replicated), None if the name map
    has none."""
    if name in _NAME_RULES:
        axes = _NAME_RULES[name]
        if len(axes) == ndim:
            return axes
        # Stacked-over-layers leaves get a leading (replicated) layer dim.
        if len(axes) == ndim - 1:
            return (None,) + axes
        if len(axes) == ndim - 2:
            return (None, None) + axes
    return None


def _leaf_logical_axes(path, leaf) -> "tuple | None":
    return leaf_axes(_leaf_name(path), leaf.ndim)


def param_shardings(params, mesh: Optional[Mesh],
                    rules: Optional[dict] = None):
    """NamedSharding tree for a param tree (meta tensors serve)."""
    if mesh is None:
        return tree.tree_map(lambda _: None, params)
    with logical.use_rules(mesh, rules):
        def one(path, leaf):
            axes = _leaf_logical_axes(path, leaf)
            if axes is None:
                return NamedSharding(mesh, ())      # replicate
            s = logical.sharding_for(leaf.shape, axes)
            return s if s is not None else NamedSharding(mesh, ())
        return tree.unflatten(params, [one(path, leaf) for path, leaf
                                       in tree.flatten_with_path(params)])


def batch_shardings(batch, mesh: Optional[Mesh],
                    rules: Optional[dict] = None):
    """Shard the leading (batch) dim of every input leaf over (pod,
    data)."""
    if mesh is None:
        return tree.tree_map(lambda _: None, batch)
    with logical.use_rules(mesh, rules):
        def one(leaf):
            axes = ("batch",) + (None,) * (leaf.ndim - 1)
            s = logical.sharding_for(leaf.shape, axes)
            return s if s is not None else NamedSharding(mesh, ())
        return tree.tree_map(one, batch)


def _cache_axes(shape, model: int) -> tuple:
    """The logical axes of a cache leaf of ``shape`` on a model axis of
    ``model`` (the reference's choice, leaf by leaf)."""
    if len(shape) == 5:
        # (L, B, Hkv, S, D) KV cache or (L, B, H, C, C) rwkv state.
        heads, seq = shape[2], shape[3]
        if heads % model == 0:
            return (None, "batch", "kv_heads", None, None)
        if seq % model == 0:
            return (None, "batch", None, "heads", None)
        return (None, "batch", None, None, None)
    if len(shape) >= 2:
        return (None, "batch") + (None,) * (len(shape) - 2)
    return (None,) * len(shape)


def cache_shardings(cache, mesh: Optional[Mesh], cfg,
                    rules: Optional[dict] = None):
    """KV caches: batch over (pod, data); the model axis takes the KV-head
    dim when it divides, else the cache *sequence* dim (sequence-parallel
    decode attention — e.g. deepseek-67b's 8 KV heads on a 16-way model
    axis), else neither (the cache whole over ``model``)."""
    if mesh is None:
        return tree.tree_map(lambda _: None, cache)
    model = mesh.shape.get("model", 1)
    with logical.use_rules(mesh, rules):
        def one(leaf):
            s = logical.sharding_for(leaf.shape,
                                     _cache_axes(leaf.shape, model))
            return s if s is not None else NamedSharding(mesh, ())
        return tree.tree_map(one, cache)


# ---------------------------------------------------------------------------
# Each rank's shards as plain tensors, and their inverse.
# ---------------------------------------------------------------------------

def axis_names(entry) -> "tuple[str, ...]":
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_of(name: "str | None", shape) -> tuple:
    """A leaf's spec under the active rules, from its global shape: the
    reference's ``param_shardings`` entry (all None where it replicates)."""
    axes = leaf_axes(name, len(shape))
    spec = logical.spec_for(tuple(shape), axes) if axes else None
    return spec if spec is not None else (None,) * len(shape)


def local_shape(mesh: Mesh, shape, spec) -> "tuple[int, ...]":
    return tuple(n // math.prod(mesh.shape[a] for a in axis_names(e))
                 for n, e in zip(shape, spec))


def block_index(mesh: Mesh, names) -> int:
    """This rank's index over ``names`` together, major first."""
    idx = 0
    for a in names:
        idx = idx * mesh.shape[a] + mesh.index(a)
    return idx


def glu_paired(whole: int, n: int) -> bool:
    """Whether a GLU's (gate | up) dim of ``whole`` columns split over
    ``n`` ranks takes the paired shard: where each half splits.  Where
    only the whole does, the rank holds the reference's contiguous
    shard, and a block gathers it whole before it runs."""
    return n == 1 or (whole // 2) % n == 0


def shard_leaf(x: torch.Tensor, spec, mesh: Mesh, glu: bool = False):
    """This rank's shard of the whole leaf ``x`` under ``spec`` (a view);
    ``glu``: the last dim is (gate | up), split pairwise where its halves
    split (``glu_paired``)."""
    for d, entry in enumerate(spec):
        names = axis_names(entry)
        if not names:
            continue
        n = math.prod(mesh.shape[a] for a in names)
        i = block_index(mesh, names)
        if glu and d == x.ndim - 1 and glu_paired(x.shape[d], n):
            pairs = x.unflatten(d, (2, x.shape[d] // 2))
            size = pairs.shape[d + 1] // n
            x = pairs.narrow(d + 1, i * size, size).flatten(d, d + 1)
        else:
            size = x.shape[d] // n
            x = x.narrow(d, i * size, size)
    return x


def gather_leaf(x: torch.Tensor, spec, mesh: Mesh, glu: bool = False):
    """The whole leaf from each rank's ``x`` (``shard_leaf``'s inverse):
    all-gathers over every axis the spec names, no autograd."""
    from repro_torch.distributed import collectives
    for d, entry in enumerate(spec):
        names = tuple(a for a in axis_names(entry) if mesh.shape[a] > 1)
        if not names:
            continue
        n = math.prod(mesh.shape[a] for a in names)
        if glu and d == x.ndim - 1 and glu_paired(x.shape[d] * n, n):
            x = x.unflatten(d, (2, x.shape[d] // 2))
            for a in reversed(names):              # minor axis first
                x = collectives.all_gather(x, mesh.group(a), d + 1)
            x = x.flatten(d, d + 1)
        else:
            for a in reversed(names):
                x = collectives.all_gather(x, mesh.group(a), d)
    return x


def _own(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a tensor that owns its memory (a view of a larger leaf is
    copied, so that the whole leaf can be freed)."""
    if x.is_meta:
        return torch.empty_like(x, memory_format=torch.contiguous_format)
    if (x.is_contiguous() and x.untyped_storage().nbytes()
            == x.numel() * x.element_size()):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def param_specs(params):
    """Each leaf's spec under the active rules: a list in tree order."""
    return [spec_of(_leaf_name(path), leaf.shape)
            for path, leaf in tree.flatten_with_path(params)]


def shard_params(params, mesh: Mesh, rules: Optional[dict] = None, *,
                 glu: bool):
    """Each leaf of a whole tree (params, or an optimizer state that
    mirrors them) as this rank's shard under ``rules``, a plain tensor
    that owns its memory (a leaf kept whole is returned as it is); with
    ``glu`` (the config's ``mlp_glu``) the ``wi`` leaves are GLU
    projections (``shard_leaf``).  On ``meta`` leaves, the shards'
    shapes."""
    with logical.use_rules(mesh, rules):
        out = [_own(shard_leaf(leaf, spec_of(_leaf_name(path), leaf.shape),
                               mesh, glu and _leaf_name(path) in GLU_LEAVES))
               for path, leaf in tree.flatten_with_path(params)]
    return tree.unflatten(params, out)


def gather_params(local, like, mesh: Mesh, rules: Optional[dict] = None,
                  leaf_fn=None, *, glu: bool):
    """The whole tree in the reference's layout from each rank's shards
    ``local`` (``shard_params``'s inverse, with the same ``glu``);
    ``like`` has the whole shapes (``meta`` serves).  Every rank of the
    mesh calls it.
    ``leaf_fn(i, whole)`` is applied to each whole leaf as it is
    gathered, one leaf at a time (a checkpoint copies it to the host);
    its results are returned instead of the leaves."""
    with logical.use_rules(mesh, rules):
        out = []
        for i, ((path, x), big) in enumerate(zip(
                tree.flatten_with_path(local), tree.leaves(like))):
            whole = gather_leaf(x, spec_of(_leaf_name(path), big.shape),
                                mesh, glu and _leaf_name(path) in GLU_LEAVES)
            out.append(whole if leaf_fn is None else leaf_fn(i, whole))
    return tree.unflatten(local, out)


#: the attribute of a rank's cache leaf that holds the whole leaf's shape
#: (``shard_cache``): a leaf whose whole holds every KV head reads the
#: same, a share of the positions or all of them, and only the whole
#: length tells which
WHOLE_SHAPE = "whole_shape"


def shard_cache(cache, mesh: Mesh, cfg, rules: Optional[dict] = None):
    """This rank's shard of each cache leaf (``cache_shardings``), a
    tensor that owns its memory: its KV heads where they divide
    ``model``; else, where the length does, every head at its share of
    the positions (``[r·S/m, (r+1)·S/m)`` on rank r of ``model``: the
    sequence-parallel decode attention of ``models/transformer.py``);
    else every head at every position.  Each leaf carries the whole
    leaf's shape (``WHOLE_SHAPE``), which ``cache_placement`` reads."""
    shardings = cache_shardings(cache, mesh, cfg, rules)
    out = []
    for leaf, s in zip(tree.leaves(cache), tree.leaves(shardings)):
        x = _own(shard_leaf(leaf, s.spec, mesh))
        setattr(x, WHOLE_SHAPE, tuple(leaf.shape))
        out.append(x)
    return tree.unflatten(cache, out)


def gather_cache(local, mesh: Mesh, cfg, rules: Optional[dict] = None):
    """The whole cache from each rank's shards (``shard_cache``'s
    inverse): all-gathers each leaf over the axes its spec names.  Every
    rank of the mesh calls it."""
    with logical.use_rules(mesh, rules):
        specs = [cache_placement(x, cfg, mesh)[1] for x in tree.leaves(local)]
    return tree.unflatten(local, [gather_leaf(x, spec, mesh) for x, spec
                                  in zip(tree.leaves(local), specs)])


def cache_placement(leaf, cfg, mesh: Mesh):
    """(the whole shape, the spec) of a rank's cache leaf under the
    active rules: from its ``WHOLE_SHAPE``, or, where a leaf lacks it (a
    shard rebuilt from its shape alone), from the one whole length whose
    spec gives the leaf's shape: the leaf's own, or that times the ranks
    of the axes the sequence may take (the batch is the rank's rows
    either way).  Raises where both do: a leaf of every KV head can be a
    share of the positions or all of them.  A recurrent state leaf (not
    5-D) has no such reading where the batch axes split anything: its
    rows or, unstacked, its channels."""
    shape = tuple(leaf.shape)
    model = mesh.shape.get("model", 1)
    whole = getattr(leaf, WHOLE_SHAPE, None)
    if whole is not None:
        return whole, _spec_of_cache(whole, model)
    if len(shape) != 5:
        batch = axis_names(logical._ACTIVE[-1][1].get("batch"))
        if any(mesh.shape.get(a, 1) > 1 for a in batch):
            raise ValueError(
                f"a state leaf of {shape} on {mesh!r} has no whole shape: "
                "place the cache with sharding.shard_cache, which records "
                "its whole shape")
        return shape, _spec_of_cache(shape, model)
    fits = []
    for n in sorted({1, _seq_ranks(mesh)}):
        cand = shape[:2] + (cfg.n_kv_heads, shape[3] * n, shape[4])
        spec = _spec_of_cache(cand, model)
        if local_shape(mesh, cand, spec)[2:] == shape[2:]:
            fits.append((cand, spec))
    if len(fits) != 1:
        raise ValueError(
            f"a cache leaf of {shape} on {mesh!r} is a shard of "
            f"{[f[0] for f in fits] or 'no whole leaf'}: place the cache "
            "with sharding.shard_cache, which records its whole shape")
    return fits[0]


def _spec_of_cache(shape, model: int) -> tuple:
    spec = logical.spec_for(tuple(shape), _cache_axes(shape, model))
    return spec if spec is not None else (None,) * len(shape)


def _seq_ranks(mesh: Mesh) -> int:
    """The ranks the active rules give a cache's sequence (``heads``)."""
    names = axis_names(logical._ACTIVE[-1][1].get("heads"))
    return math.prod(mesh.shape[a] for a in names if a in mesh.shape)


def local_batch(batch, mesh: Mesh, microbatches: int = 1,
                rules: Optional[dict] = None):
    """This rank's rows of a whole batch: of each of the ``microbatches``
    slices of the leading dim, the rows ``batch_shardings`` gives the
    rank, in order; the train step then slices the local batch into the
    same ``microbatches`` (``train_step._split_microbatch``).  A leaf the
    rules keep whole stays whole."""
    shardings = batch_shardings(batch, mesh, rules)

    def one(x, s):
        names = axis_names(s.spec[0]) if s.spec else ()
        if not names:
            return x
        n = math.prod(mesh.shape[a] for a in names)
        if x.shape[0] % (microbatches * n):
            raise ValueError(f"a batch of {x.shape[0]} rows does not split "
                             f"into {microbatches} microbatches over {n} "
                             "ranks")
        mb = x.shape[0] // microbatches
        i = block_index(mesh, names)
        rows = x.unflatten(0, (microbatches, n, mb // n))[:, i]
        return _own(rows.flatten(0, 1))
    return _map_pair(one, batch, shardings)


def apply_shardings(t, shardings):
    """Each leaf placed by its NamedSharding as a DTensor (a leaf whose
    sharding is None stays as it is).  Every rank passes the whole leaf
    and keeps its own shard: ``distribute_tensor`` with
    ``src_data_rank=None`` communicates nothing."""
    from torch.distributed.tensor import distribute_tensor

    def one(x, s):
        if s is None:
            return x
        return distribute_tensor(x, s.mesh.device_mesh, s.placements,
                                 src_data_rank=None)
    return _map_pair(one, t, shardings)


def _map_pair(fn, t, other):
    """``fn(leaf, s)`` over the leaves of ``t`` and what ``other`` holds
    at each leaf's place; ``other`` may hold None in place of a subtree,
    as a sharding tree does (``jax.tree.map`` with ``t`` as the prefix)."""
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: _map_pair(fn, v, None if other is None else other[k])
                for k, v in t.items()}
    if isinstance(t, (tuple, list)):
        return type(t)(_map_pair(fn, v, None if other is None else other[i])
                       for i, v in enumerate(t))
    return fn(t, other)


def local_shards(t):
    """Each DTensor leaf as this rank's shard, a plain tensor that owns
    its memory (``_own``); other leaves as they are."""
    from torch.distributed.tensor import DTensor
    return tree.tree_map(lambda x: _own(x.to_local())
                         if isinstance(x, DTensor) else x, t)


# ---------------------------------------------------------------------------
# Cluster-partitioned GEMM: the execution mirror of sim.partition.
# ---------------------------------------------------------------------------

def shard_map_gemm(a, b, n_units: int, dim: str = "m",
                   accum_dtype=None, bounds=None) -> torch.Tensor:
    """Accumulator-precision GEMM sharded over ``n_units``, each span
    one K1 call (``cute_matmul``'s accumulator route).

    ``dim="m"`` shards A's rows (row-panel partition: each unit owns full
    output rows), ``dim="n"`` shards B's columns (output-tile partition).
    ``bounds`` is the per-unit ``(lo, hi)`` extent list of a
    ``sim.partition.Partition`` (``None`` entries for idle units), so
    execution reproduces the unit-to-data mapping the DES timed; omitted,
    an even split is assumed.  When the spans are the even split and the
    world has ``n_units`` ranks, rank u computes span u and an
    ``all_gather`` assembles the result on every rank; otherwise the
    spans run as a loop in this process (the reference's rule, where a
    host with too few devices loops).  Integer dots are bit-exact either
    way.  ``accum_dtype`` defaults to int32 for int8 inputs and fp32
    otherwise.  Returns the full (M, N) accumulator.
    """
    import torch.distributed as dist

    from repro_torch.distributed import collectives
    if dim not in ("m", "n"):
        raise ValueError(f"dim must be 'm' or 'n', got {dim!r}")
    if accum_dtype is None:
        accum_dtype = (torch.int32 if a.dtype in (torch.int8, torch.uint8)
                       else torch.float32)

    def dot(a_s, b_s):
        from repro_torch.core.fusion import Epilogue, cute_matmul
        return cute_matmul(a_s, b_s, epilogue=Epilogue(out_dtype=accum_dtype),
                           backend="kernel")

    size = a.shape[0] if dim == "m" else b.shape[1]
    even = [(size * u // n_units, size * (u + 1) // n_units)
            for u in range(n_units)]
    if bounds is None:
        bounds = even
    if (n_units == 1 or list(bounds) != even or size % n_units != 0
            or not dist.is_initialized()
            or dist.get_world_size() != n_units):
        return _sliced_gemm(a, b, bounds, dim, dot)
    lo, hi = even[dist.get_rank()]
    part = dot(a[lo:hi], b) if dim == "m" else dot(a, b[:, lo:hi])
    return collectives.all_gather(part, dim=0 if dim == "m" else 1)


def _sliced_gemm(a, b, bounds, dim, dot):
    parts = []
    for span in bounds:
        if span is None:
            continue
        lo, hi = span
        if hi <= lo:
            continue
        parts.append(dot(a[lo:hi], b) if dim == "m"
                     else dot(a, b[:, lo:hi]))
    return torch.cat(parts, dim=0 if dim == "m" else 1)
