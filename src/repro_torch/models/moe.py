"""Top-k MoE block (OLMoE 64e/top-8, Arctic 128e/top-2 + dense residual).

Each call sort-dispatches its tokens to the experts with capacity
``moe_capacity`` (overflow is dropped, GShard-style), runs the expert
MLPs as two grouped GEMMs and combines the outputs with the gate
weights.  ``moe_apply_local`` takes a window of experts
(``e_start``, ``wi_local.shape[0]``), as in the reference, so that the
partial outputs of disjoint windows sum to the whole.

Distribution (EP): under a mesh with a ``model`` axis, activations are
replicated across ``model`` and the experts are sharded across it.  On a
rank of the active rules' mesh (``distributed.tensor_parallel``: a
trained model, or a served one placed by
``sharding.EXPERT_PARALLEL_RULES``) the block takes the rank's rows of
the batch, as the rest of the model does; the rank routes them to the
experts it holds (gathered over the data axes where FSDP shards their
width), runs the grouped GEMMs (K4) on them behind the region's entry
and forms its partial output, and ``reduce_from_group`` sums the
partials over ``model`` (the reference's ``psum``, in the activation
dtype), its backward passing the gradient on, so that the block trains
(``_moe_expert_parallel``).  ``moe_apply(..., mesh=)`` on one of the
mesh's ranks is the reference's ``shard_map`` call: the whole batch in,
the rank's data slice through the same function, an all-gather over the
data axes after.  The reference writes this as ``shard_map``; here each
rank is a process and the collectives go through
``distributed.collectives``.  Under a mesh without ranks
(``launch.mesh.abstract_mesh``) one process runs every shard in turn over
the whole expert leaves and adds the partials in shard order
(``_moe_shards_in_turn``).  Without a mesh the same function runs with
``e_start=0`` and all experts local.

GSPMD expert parallelism (``moe_shard_map=False`` under a mesh: the
reference's ``else`` branch, one routing over the whole batch with its
capacity, which GSPMD partitions over wherever the rules put the expert
leaves): the leaves stay the rank's shards, its ``E/|experts axes|``
experts from its block of them, each with its ``d_ff/|mlp_expert
axes|`` slice (gate and up columns paired, ``sharding.GLU_LEAVES``).
The tokens move instead: a rank all-gathers ``x`` over every batch axis
(pod major), routes the whole batch with the replicated router, runs
``moe_apply_local`` on its experts and d_ff slice at the whole batch's
capacity, so that the same tokens overflow as in the reference, and
forms an fp32 partial of every token's output.  The partials are summed
over the axes that split the experts or d_ff: a reduce-scatter over
each such batch axis (the rank's rows), then an all-reduce over each
other one, one axis at a time; the sum is rounded once to the
activation dtype (``_moe_gspmd``).  An abstract mesh runs every rank's
partial in turn and adds them in the same order (``_moe_gspmd_in_turn``):
where each of those axes has at most two ranks, every sum is of two
terms, and the ranks' result equals it bit for bit.  It trains too:
each collective of the forward is its autograd pair (the gather's
backward reduce-scatters, the reduce-scatter's gathers, the all-reduce's
passes the gradient on), so each axis sums a gradient once; a leaf or
input that the ranks of a non-batch axis use for different partials
(the router and ``x`` where ``model`` splits the experts or d_ff, and
under sequence parallelism the expert leaves where it does not) enters
with ``copy_to_group`` over it.  The experts may lie over ``model`` and
another axis together (``{"experts": ("data", "model")}``): the rank
holds its block of them, data major.

Under sequence parallelism (the rules map ``seq`` to ``model``) a rank's
``x`` is its share of the sequence.  Both forms gather the sequence
first and route the gathered tokens at the capacity of the whole
sequence, as the reference routes them; the sum over ``model`` is then a
reduce-scatter along the sequence, each rank keeping its share.
"""

from __future__ import annotations

import contextlib
import itertools
import math

import torch

from repro_torch.core.fusion import ACTIVATIONS, Epilogue, linear
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import common as cm
from repro_torch.models.base import ArchConfig


def moe_init(cfg: ArchConfig, gen: torch.Generator, device=None):
    """Seeded parameters with the reference's distributions, fan-ins as
    it writes them: ``experts_wi`` divides by sqrt(n_experts) (its
    ``in_axis`` 0), ``experts_wo`` by sqrt(d_model)."""
    m = cfg.moe
    d = cfg.d_model
    mult = 2 if cfg.mlp_glu else 1
    kw = dict(device=device)
    p = {
        "w_router": cm.dense_init(gen, (d, m.n_experts), torch.float32, **kw),
        "experts_wi": cm.dense_init(
            gen, (m.n_experts, d, mult * m.d_ff_expert), cfg.dtype, **kw),
        "experts_wo": cm.dense_init(
            gen, (m.n_experts, m.d_ff_expert, d), cfg.dtype, in_axis=2,
            **kw),
    }
    if m.dense_parallel:
        p["dense_wi"] = cm.dense_init(gen, (d, mult * cfg.d_ff), cfg.dtype,
                                      **kw)
        p["dense_wo"] = cm.dense_init(gen, (cfg.d_ff, d), cfg.dtype,
                                      in_axis=1, **kw)
    return p


def _expert_ffn(cfg: ArchConfig, wi, wo, x, occupancy=None,
                out_dtype=None):
    """x: (E_l, C, d) -> (E_l, C, d) through the per-expert GLU MLP, in
    ``out_dtype`` (x's dtype where None).

    ``cfg.backend == "kernel"`` runs the grouped-GEMM kernel (its plain
    version on CPU tensors); ``"torch"`` and ``"dense"`` run the einsum
    form, accumulating in fp32.  ``occupancy``: the kernel's promises of
    zero rows in ``x`` (``rows``, ``max_rows``, ``max_experts`` of
    ``grouped_matmul``), passed on to the second GEMM too where the first
    one's epilogue keeps zero rows zero.
    """
    if cfg.backend == "kernel":
        from repro_torch.kernels.moe.ops import (grouped_matmul,
                                                 keeps_zero_rows)
        occupancy = occupancy or {}
        ep = Epilogue(activation=cfg.mlp_activation, glu=cfg.mlp_glu,
                      out_dtype=x.dtype)
        h = grouped_matmul(x, wi, epilogue=ep, **occupancy)
        return grouped_matmul(h, wo, epilogue=Epilogue(out_dtype=out_dtype),
                              **(occupancy if keeps_zero_rows(ep) else {}))
    if cfg.backend not in ("torch", "dense"):
        raise ValueError(f"unknown MoE backend {cfg.backend!r}; use "
                         "'kernel', 'torch' or 'dense'")
    h = torch.einsum("ecd,edf->ecf", x.float(), wi.float())
    act = ACTIVATIONS[cfg.mlp_activation]
    if cfg.mlp_glu:
        half = h.shape[-1] // 2
        h = act(h[..., :half]) * h[..., half:]
    else:
        h = act(h)
    h = h.to(x.dtype)
    return torch.einsum("ecf,efd->ecd", h.float(), wo.float()).to(
        out_dtype or x.dtype)


def route(cfg: ArchConfig, x2d, w_router):
    """Router: (gate (T, k) fp32, expert index (T, k)).

    The product is fp32 (TF32 must be off on the card:
    ``core.precision.disable_tf32``).  ``jax.lax.top_k`` breaks ties
    toward the lower index and ``torch.topk`` promises no order among
    ties; with fp32 softmax probabilities of continuous inputs, ties do
    not occur.
    """
    probs = torch.softmax(x2d.float() @ w_router, dim=-1)
    gate, idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    if cfg.moe.renormalize:
        gate = gate / gate.sum(dim=-1, keepdim=True)
    return gate, idx


def moe_apply_local(cfg: ArchConfig, x2d, w_router, wi_local, wo_local,
                    e_start: int, capacity: int, out_dtype=None):
    """Partial MoE output of the locally-held experts.

    x2d: (T, d); wi_local: (E_l, d, mult·ff); e_start: first owned expert.
    Returns (T, d), in ``out_dtype`` (x2d's dtype where None): the
    second expert GEMM's output, the gate products and each token's sum
    are all in it.
    """
    k = cfg.moe.top_k
    t, d = x2d.shape
    e_local = wi_local.shape[0]
    odt = out_dtype or x2d.dtype

    gate, idx = route(cfg, x2d, w_router)
    flat_idx = idx.reshape(-1)                             # (T·k,)
    flat_gate = gate.reshape(-1)
    local_e = torch.where(
        (flat_idx >= e_start) & (flat_idx < e_start + e_local),
        flat_idx - e_start, e_local)                       # e_local = trash

    # Stable, as jnp.argsort: the order decides which tokens overflow.
    order = torch.argsort(local_e, stable=True)
    sorted_e = local_e[order]
    # bincount's output size depends on the data: it has no meta kernel,
    # and on the card it reads the maximum back to the host
    counts = torch.zeros(e_local + 1, dtype=torch.int64,
                         device=x2d.device).scatter_add_(
        0, local_e, torch.ones_like(local_e))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * k, device=x2d.device) - starts[sorted_e]
    keep = (sorted_e < e_local) & (rank < capacity)
    trash = e_local * capacity
    slot = torch.where(keep, sorted_e * capacity + rank, trash)
    token = order // k

    # Dropped entries all write the trash row, which is then cut off.
    disp = torch.zeros((trash + 1, d), dtype=x2d.dtype, device=x2d.device)
    disp[slot] = torch.where(keep[:, None], x2d[token], 0.0).to(x2d.dtype)
    disp = disp[:-1].reshape(e_local, capacity, d)

    # Expert e's kept tokens fill rows [0, rows[e]) of its capacity block
    # and the rest stay zero; top-k picks distinct experts per token, so
    # no expert holds more than t rows, and at most t * k experts hold one.
    occupancy = dict(
        rows=torch.clamp(counts[:e_local], max=capacity).to(torch.int32),
        max_rows=min(capacity, t), max_experts=min(e_local, t * k))
    y = _expert_ffn(cfg, wi_local, wo_local, disp, occupancy,
                    odt)                                   # (E_l, C, d)
    y_flat = y.reshape(trash, d)

    contrib = torch.where(
        keep[:, None],
        flat_gate[order][:, None].to(odt)
        * y_flat[torch.clamp(slot, max=trash - 1)], 0.0).to(odt)
    # The reference scatter-adds ``contrib`` into zeros in its sorted
    # order.  Atomics would make the order, and so the rounding in
    # x2d's dtype, change from run to run; instead each token's k
    # contributions are gathered, in that same sorted order, and added
    # one after another.
    per_token = contrib[torch.argsort(token, stable=True)].reshape(t, k, d)
    out = torch.zeros((t, d), dtype=odt, device=x2d.device)
    for j in range(k):
        out = out + per_token[:, j]
    return out


def moe_capacity(cfg: ArchConfig, tokens_local: int) -> int:
    m = cfg.moe
    cap = int(tokens_local * m.top_k * m.capacity_factor / m.n_experts) + 1
    return max(8, cap + (-cap) % 8)


def moe_apply(cfg: ArchConfig, p, x, mesh=None):
    """x: (B, S, d) -> (B, S, d).  On a rank of the active rules' mesh,
    ``x`` is the rank's rows (``_moe_expert_parallel``, or ``_moe_gspmd``
    with ``moe_shard_map=False``).  With ``mesh`` given and this process
    one of its ranks, ``x`` is the whole batch (``_moe_on_rank``).  On an
    abstract mesh with a ``model`` axis the experts divide, every shard
    in turn (``_moe_shards_in_turn``); with ``moe_shard_map=False`` every
    rank's partial in turn where the rules split the expert leaves
    (``_moe_gspmd_in_turn``); all experts here otherwise."""
    b, s, d = x.shape
    m = cfg.moe
    pl = None
    if mesh is None:
        from repro_torch.distributed import logical
        pl, mesh = tp.current(), logical.active_mesh()
    elif mesh.has_rank:
        return _moe_on_rank(cfg, p, x, mesh)
    model = mesh.shape.get("model", 1) if mesh is not None else 1
    dense = (p.get("dense_wi"), p.get("dense_wo"))
    if pl is not None:
        y = (_moe_expert_parallel(cfg, pl, p, x) if cfg.moe_shard_map
             else _moe_gspmd(cfg, pl, p, x))
        if cfg.moe.dense_parallel:
            dense = (pl.param(dense[0], "dense_wi",
                              (d, (2 if cfg.mlp_glu else 1) * cfg.d_ff))[0],
                     pl.param(dense[1], "dense_wo", (cfg.d_ff, d))[0])
            if pl.seq:      # whole, on the rank's rows: gradients shares
                dense = tuple(pl.whole_in_region(w) for w in dense)
    elif (cfg.moe_shard_map and mesh is not None and "model" in mesh.shape
            and m.n_experts % model == 0):
        y = _moe_shards_in_turn(cfg, p, x, mesh)
    elif not cfg.moe_shard_map and mesh is not None and any(
            _gspmd_axes(cfg, mesh)[:2]):
        y = _moe_gspmd_in_turn(cfg, p, x, mesh)
    else:
        capacity = moe_capacity(cfg, b * s)
        y = moe_apply_local(cfg, x.reshape(-1, d), p["w_router"],
                            _experts(p["experts_wi"], m.n_experts),
                            _experts(p["experts_wo"], m.n_experts), 0,
                            capacity).reshape(b, s, d)
    if cfg.moe.dense_parallel:
        # Arctic: dense residual MLP in parallel with the MoE branch (its
        # leaves are replicated by the rules: whole on every rank).
        h = linear(x, dense[0], activation=cfg.mlp_activation,
                   glu=cfg.mlp_glu)
        y = y + linear(h, dense[1])
    return y


def _moe_expert_parallel(cfg: ArchConfig, pl, p, x):
    """The block on a rank of a placed model (the reference's
    ``shard_map`` branch on its data slice): ``x`` is the rank's rows,
    capacity from their tokens over the whole sequence.  Where the rules
    split the expert leaves over ``model`` (in any dim, alone or with
    another axis: the rank then takes its contiguous ``model`` block of
    the experts, as the reference's ``shard_map`` reshards them to
    ``P("model")``, ``Placement.reshard``) the rank runs its ``e_local``
    from ``rank * e_local`` behind the region's entry (which gathers the sequence
    under sequence parallelism) and the partials are summed by the
    region's exit in the activation dtype, as the reference's ``psum``
    (a reduce-scatter along the sequence under sequence parallelism);
    the router, replicated, takes the region's gradient share
    (``whole_in_region``).  Whole experts under sequence parallelism
    route the gathered sequence on every rank, which keeps its rows."""
    d = x.shape[-1]
    m = cfg.moe
    mult = 2 if cfg.mlp_glu else 1
    router = pl.reshard(*pl.param(p["w_router"], "w_router",
                                  (d, m.n_experts)), None)
    shapes = {"experts_wi": (m.n_experts, d, mult * m.d_ff_expert),
              "experts_wo": (m.n_experts, m.d_ff_expert, d)}
    wi, ed = pl.param(p["experts_wi"], "experts_wi", shapes["experts_wi"],
                      glu=cfg.mlp_glu)
    wo, od = pl.param(p["experts_wo"], "experts_wo", shapes["experts_wo"])
    split = m.n_experts % pl.model == 0 and any(
        pl.splits_model(k, v) for k, v in shapes.items())
    wi = pl.reshard(wi, ed, 0 if split else None, cfg.mlp_glu)
    wo = pl.reshard(wo, od, 0 if split else None)
    if not split:
        if pl.seq:
            router, wi, wo = (pl.whole_in_region(t) for t in (router, wi, wo))
            x = pl.gather_model(x, 1)
        b, s, _ = x.shape
        out = moe_apply_local(cfg, x.reshape(-1, d), router, wi, wo, 0,
                              moe_capacity(cfg, b * s)).reshape(b, s, d)
        return pl.seq_rows(out)
    e_local = m.n_experts // pl.model
    xs = pl.enter(x)
    b, s, _ = xs.shape
    out = moe_apply_local(cfg, xs.reshape(-1, d),
                          pl.whole_in_region(router), wi, wo,
                          pl.rank * e_local, moe_capacity(cfg, b * s))
    return pl.exit(out.reshape(b, s, d))


def _moe_on_rank(cfg: ArchConfig, p, x, mesh):
    """``moe_apply(..., mesh=)`` on a rank of ``mesh``: ``x`` is the whole
    batch and ``p`` the rank's leaves under the active rules where they
    are ``mesh``'s, else under ``sharding.EXPERT_PARALLEL_RULES``.  The
    rank's data slice runs the block under those rules
    (``_moe_expert_parallel``, or ``_moe_gspmd``), and the slices are
    all-gathered over the data axes, pod major."""
    from repro_torch.distributed import collectives, sharding
    data_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    n_data, data_idx = 1, 0
    for a in data_axes:                                # pod major
        n_data *= mesh.shape[a]
        data_idx = data_idx * mesh.shape[a] + mesh.index(a)
    b_local = x.shape[0] // n_data
    with _rules_of(mesh, sharding.EXPERT_PARALLEL_RULES):
        out = moe_apply(cfg, p,
                        x[data_idx * b_local:(data_idx + 1) * b_local])
    for a in reversed(data_axes):          # data within pod, then pod
        if mesh.shape[a] > 1:
            out = collectives.all_gather(out, mesh.group(a))
    return out


def _experts(w: torch.Tensor, n: int) -> torch.Tensor:
    """An expert leaf that must hold ``n`` experts."""
    if w.shape[0] != n:
        raise ValueError(f"an expert leaf of {w.shape[0]} experts where "
                         f"{n} are expected (a rank's shard runs under its "
                         "mesh, whole leaves without one or under an "
                         "abstract mesh)")
    return w


def _moe_shards_in_turn(cfg: ArchConfig, p, x, mesh):
    """Expert parallelism on an abstract mesh (sizes, no ranks): this
    process runs every data slice of ``x`` and every shard of the whole
    expert leaves in turn, capacity from the slice's tokens, adding the
    partials in shard order in the activation dtype.  With two shards
    that is the two-rank all-reduce bit for bit (one rounding of the
    exact sum of two partials), so a run on one device holds the ranks'
    arithmetic; against ``moe_apply_local`` over all experts, which adds
    each token's contributions in one sum, the output differs by the
    rounding of the partials."""
    b, s, d = x.shape
    m = cfg.moe
    n_shards = mesh.shape["model"]
    e_local = m.n_experts // n_shards
    n_data = 1
    for a in ("pod", "data"):
        n_data *= mesh.shape.get(a, 1)
    b_local = b // n_data
    capacity = moe_capacity(cfg, b_local * s)
    wi = _experts(p["experts_wi"], m.n_experts)
    wo = _experts(p["experts_wo"], m.n_experts)
    outs = []
    for i in range(n_data):                            # pod major
        x_l = x[i * b_local:(i + 1) * b_local]
        y = None
        for shard in range(n_shards):
            window = slice(shard * e_local, (shard + 1) * e_local)
            part = moe_apply_local(cfg, x_l.reshape(-1, d), p["w_router"],
                                   wi[window], wo[window], shard * e_local,
                                   capacity).reshape(x_l.shape)
            y = part if y is None else y + part
        outs.append(y)
    return torch.cat(outs)


def _rules_of(mesh, rules=None):
    """The active rules where they are ``mesh``'s, else ``rules`` on it
    (the default ones where None)."""
    from repro_torch.distributed import logical
    return (contextlib.nullcontext() if logical.active_mesh() is mesh
            else logical.use_rules(mesh, rules))


def _gspmd_axes(cfg: ArchConfig, mesh):
    """(the axes that split the experts, those that split each expert's
    d_ff, the order in which the partials are summed over them), each of
    more than one rank, under ``_rules_of(mesh)``.  The order: the batch
    axes major first (each rank's rows, by reduce-scatters), then the
    others in the mesh's order.  A dim may be split over several axes
    (the rank's block, major first).  Each expert's d_ff axes are
    ``experts_wi``'s, which ``experts_wo`` holds, perhaps with more
    (``_moe_gspmd``)."""
    from repro_torch.distributed import logical, sharding
    m = cfg.moe
    mult = 2 if cfg.mlp_glu else 1
    with _rules_of(mesh):
        wi = sharding.spec_of("experts_wi", (m.n_experts, cfg.d_model,
                                             mult * m.d_ff_expert))
        wo = sharding.spec_of("experts_wo", (m.n_experts, m.d_ff_expert,
                                             cfg.d_model))
        batch = [a for a in sharding.axis_names(
            logical._ACTIVE[-1][1].get("batch")) if a in mesh.shape]

    def axes(entry):
        return tuple(a for a in sharding.axis_names(entry)
                     if mesh.shape[a] > 1)
    # the experts take their axes first in both leaves; each expert's
    # d_ff comes after d_model in experts_wi and before it in experts_wo,
    # so that wi's d_ff axes are wo's less those d_model took in wi: the
    # partials split over wi's (``_moe_gspmd`` gathers wo's others)
    e_axes, f_axes = axes(wi[0]), axes(wi[2])
    if cfg.mlp_glu and not sharding.glu_paired(
            mult * m.d_ff_expert, math.prod(mesh.shape[a] for a in f_axes)):
        f_axes = ()         # halves that do not split: each d_ff whole
    split = e_axes + f_axes
    order = ([a for a in batch if a in split]
             + [a for a in mesh.axis_names if a in split and a not in batch])
    return e_axes, f_axes, order


def _moe_gspmd(cfg: ArchConfig, pl, p, x):
    """GSPMD expert parallelism on a rank of a placed model: ``x`` is the
    rank's rows, the expert leaves its shards under the active rules (not
    gathered: each rank runs its experts and d_ff slice), the router
    replicated.  ``x`` is all-gathered over the batch axes (and, under
    sequence parallelism, first over ``model`` along the sequence),
    routed whole at the whole batch's capacity, and the fp32 partials
    are summed over the splitting axes in ``_gspmd_axes``'s order, the
    rank keeping its rows (and its share of the sequence: a
    reduce-scatter along it over ``model`` where the sum runs over
    ``model``); rounded once to x's dtype.

    Under autograd each collective is its pair: the gathers' backward
    reduce-scatters the partial gradients of ``x`` (each rank's partial
    covers its experts, d_ff slice and rows), the reduce-scatters' gathers
    the gradient of every row, the all-reduces' passes it on.  ``x`` and
    the router enter each non-batch splitting axis with
    ``copy_to_group`` (their gradients there are the ranks' partials),
    and under sequence parallelism the router and, where ``model``
    splits no expert dim, the expert leaves enter ``model`` so (each
    rank's gradient covers its share of the sequence).  A batch axis
    that splits nothing leaves each rank the gradient of its own rows:
    the data-parallel sum (``reduce_gradients``, or the FSDP gather's
    reduce-scatter) adds it once."""
    from repro_torch.distributed import collectives, sharding
    b, s, d = x.shape
    m = cfg.moe
    mesh = pl.mesh
    mult = 2 if cfg.mlp_glu else 1
    router = pl.reshard(*pl.param(p["w_router"], "w_router",
                                  (d, m.n_experts)), None)
    e_axes, f_axes, order = _gspmd_axes(cfg, mesh)
    wi_shape = (m.n_experts, d, mult * m.d_ff_expert)
    wo_shape = (m.n_experts, m.d_ff_expert, d)
    wi_f, wo_f = (tuple(a for a in sharding.axis_names(
        sharding.spec_of(k, shape)[dim]) if mesh.shape[a] > 1)
        for k, shape, dim in (("experts_wi", wi_shape, 2),
                              ("experts_wo", wo_shape, 1)))
    if wi_f == f_axes:
        wi, _ = pl.param(p["experts_wi"], "experts_wi", wi_shape,
                         keep=(0, 2))
    else:           # GLU halves that do not split: each d_ff whole
        wi = pl.reshard(*pl.param(p["experts_wi"], "experts_wi", wi_shape,
                                  keep=(0,), glu=cfg.mlp_glu), None,
                        cfg.mlp_glu)
    if wo_f == f_axes:
        wo, _ = pl.param(p["experts_wo"], "experts_wo", wo_shape,
                         keep=(0, 1))
    else:       # d_ff over axes d_model took in experts_wi: whole, then
        wo = pl.reshard(*pl.param(p["experts_wo"], "experts_wo", wo_shape,
                                  keep=(0,)), None)      # wi's block of it
        if "model" in f_axes:
            wo = pl.whole_in_region(wo)
        n = wo.shape[1] // math.prod(mesh.shape[a] for a in f_axes)
        wo = wo.narrow(1, sharding.block_index(mesh, f_axes) * n, n)
    seq = pl.seq
    across = [a for a in order if a not in pl.batch_axes]
    for a in across:
        router = collectives.copy_to_group(router, pl.group(a))
        if not (seq and a == "model"):
            x = collectives.copy_to_group(x, pl.group(a))
    if seq and "model" not in across:
        router, wi, wo = (pl.whole_in_region(t) for t in (router, wi, wo))
    xs = pl.gather_model(x, 1) if seq else x
    s = xs.shape[1]
    for a in reversed(pl.batch_axes):          # data within pod, then pod
        if mesh.shape[a] > 1:
            xs = collectives.gather_from_group(xs, pl.group(a), 0)
    part = moe_apply_local(
        cfg, xs.reshape(-1, d), router, wi, wo,
        sharding.block_index(mesh, e_axes) * wi.shape[0],
        moe_capacity(cfg, xs.shape[0] * s), torch.float32).reshape(xs.shape)
    for a in pl.batch_axes:                    # major first: the rank's rows
        n = mesh.shape[a]
        if a in order:
            part = collectives.scatter_to_group(part, pl.group(a), 0)
        elif n > 1:
            rows = part.shape[0] // n
            part = part.narrow(0, mesh.index(a) * rows, rows)
    for a in across:
        if a == "model" and seq:
            part = collectives.scatter_to_group(part, pl.group(a), 1)
        else:
            part = collectives.reduce_from_group(part, pl.group(a))
    if seq and "model" not in order:
        part = pl.seq_rows(part)
    return part.to(x.dtype)


def _moe_gspmd_in_turn(cfg: ArchConfig, p, x, mesh):
    """GSPMD expert parallelism on an abstract mesh: this process runs
    each rank's partial over the whole batch in turn, on windows of the
    whole expert leaves (copied, as a rank holds its shards), and adds
    them over the splitting axes in ``_gspmd_axes``'s order, then rounds
    once."""
    b, s, d = x.shape
    m = cfg.moe
    mult = 2 if cfg.mlp_glu else 1
    e_axes, f_axes, order = _gspmd_axes(cfg, mesh)
    e_l = m.n_experts // math.prod(mesh.shape[a] for a in e_axes)
    f_l = m.d_ff_expert // math.prod(mesh.shape[a] for a in f_axes)
    wi = _experts(p["experts_wi"], m.n_experts)
    wo = _experts(p["experts_wo"], m.n_experts)
    capacity = moe_capacity(cfg, b * s)

    def block(at, axes):
        """A coordinate's block index over ``axes``, major first."""
        idx = 0
        for a in axes:
            idx = idx * mesh.shape[a] + at[a]
        return idx
    parts = {}
    for coord in itertools.product(*(range(mesh.shape[a]) for a in order)):
        at = dict(zip(order, coord))
        e0, f0 = block(at, e_axes) * e_l, block(at, f_axes) * f_l
        wi_l = wi[e0:e0 + e_l].unflatten(2, (mult, m.d_ff_expert)).narrow(
            3, f0, f_l).flatten(2).contiguous()
        wo_l = wo[e0:e0 + e_l, f0:f0 + f_l].contiguous()
        parts[coord] = moe_apply_local(cfg, x.reshape(-1, d),
                                       p["w_router"], wi_l, wo_l, e0,
                                       capacity, torch.float32)
    for _ in order:                          # one axis at a time, in order
        summed = {}
        for coord, part in parts.items():
            rest = coord[1:]
            summed[rest] = part if rest not in summed else summed[rest] + part
        parts = summed
    return parts[()].reshape(b, s, d).to(x.dtype)
