"""A rank's share of a model under a mesh: Megatron tensor parallelism
over ``model``, FSDP over the data axes, data parallelism over the batch.

The reference places every leaf by the logical rules
(``sharding.param_shardings``) and lets GSPMD move the data.  Here each
process is one rank (of a world, or a ``launch.mesh.rank_view`` on
``meta``) and holds its shards (``sharding.shard_params``); the models
ask ``current()`` for the placement of the active rules and do the
moving themselves:

* ``param`` gathers a leaf's FSDP shards over the data axes inside the
  layer that uses it (``collectives.gather_from_group``, whose backward
  reduce-scatters the gradient), so one layer at a time is whole, as
  ZeRO-3 works; under ``remat`` the recompute gathers again.  It returns
  the leaf with its ``model`` dim still sharded, and that dim; a dim
  split over ``model`` and another axis together comes back whole; dims
  in its ``keep`` stay the rank's shard (GSPMD expert parallelism moves
  the tokens to the experts, not the experts).
* ``reshard`` brings a leaf the rules place otherwise than its block's
  form to that form: gathered whole over ``model``, and the rank's shard
  of the form cut from it (a block runs in its column/row form where
  the rules split any of its leaves over ``model``, else whole).
* A column-parallel projection runs on the rank's columns behind
  ``enter`` (identity forward, gradient all-reduced over ``model``); a
  row-parallel one on its rows, then ``exit`` (all-reduce forward).
  Under sequence parallelism (the rules map ``seq`` to ``model``) the
  residual stream between blocks holds the rank's share of the sequence:
  ``enter`` all-gathers it and ``exit`` reduce-scatters.  A model's
  forward decides that once, for the pass (``begin_pass``), and every
  helper reads it (``seq_sharded``); a second stream of another length
  in the same pass (Whisper's encoder) decides its own (``shards``) and
  holds it while it runs (``holding``), remat's recompute included.  A
  block that reads its neighbours along the sequence (a token shift, a
  causal conv) takes its input whole once (``gather_stream``) and enters
  its projections with ``whole_in_region``.  A leaf the rules keep whole
  acts on the rank's rows (``seq_rows``), or, where it mixes positions,
  on the gathered stream, every rank computing every row and keeping its
  own.
* ``whole_in_region`` marks a leaf replicated over ``model`` that the
  ranks use differently inside such a region (a bias sliced to the
  rank's columns, the QK-norm scales, the MoE router, norm scales on the
  sequence shard): its gradient is a partial sum there, all-reduced.
* A leaf the rules replicate runs whole (an expert-parallel served model
  is placed and run under ``sharding.EXPERT_PARALLEL_RULES``, which
  replicate its dense leaves).  Every leaf must be the rank's shard under
  the active rules: ``param`` raises on any other shape.
* ``sum_over_batch`` adds a value over the batch axes (the loss's token
  count, a replicated leaf's gradient); ``global_norm`` counts each leaf
  once however many ranks hold it.
* ``cache_shard`` says where the rank's KV cache lies in the whole
  (``sharding.shard_cache``): its own KV heads, or every KV head at a
  share of the positions (split over ``model``) or at all of them.
* ``read_state`` and ``write_state`` move a recurrent state leaf that the
  reference keeps whole over ``model`` (Griffin's conv tail and RG-LRU
  carry) between the cache's form and the rank's rows and channels.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.distributed import collectives, logical, sharding


@dataclass(frozen=True)
class CacheShard:
    """Where a rank's KV cache leaf (L, B, Hkv, S, D) lies in the whole:
    ``every_head``, whether it holds every KV head (else the rank's own);
    positions ``[start, start + S)`` of a cache of ``length``; ``split``,
    whether the positions are shared out over ``model`` (each rank
    attends over its own and the ranks combine); ``gather``, the axes
    other than ``model`` that share them out (a block of them, major
    first), over which a rank gathers every position before it attends
    (``common.cache_view``); ``heads``, the axes that share out the KV
    heads (``common.held_heads``)."""
    every_head: bool
    start: int
    length: int
    split: bool
    gather: tuple = ()
    heads: tuple = ()

    @classmethod
    def whole(cls, length: int) -> "CacheShard":
        """A cache held whole: every KV head at all ``length`` positions
        (one process, off a mesh)."""
        return cls(every_head=True, start=0, length=length, split=False)


class Placement:
    """The placement of one rank under the active rules."""

    def __init__(self, mesh, rules: dict):
        self.mesh, self.rules = mesh, rules
        self.model = mesh.shape.get("model", 1)
        self.rank = mesh.index("model") if self.model > 1 else 0
        self.batch_axes = tuple(
            a for a in sharding.axis_names(rules.get("batch"))
            if a in mesh.shape)
        self._seq_rule = "model" in sharding.axis_names(rules.get("seq"))
        self.seq = False

    def group(self, axis: str):
        return self.mesh.group(axis)

    # -- leaves ------------------------------------------------------------
    def param(self, w: torch.Tensor, name: str, shape, keep=(),
              glu: bool = False):
        """(``w`` gathered over every axis but ``model``, the dim its
        ``model`` shard lies along or None).  ``shape`` is the whole
        leaf's, and ``w`` must be the rank's shard of it under the rules
        (the whole leaf where they replicate it).  A dim split over
        ``model`` and another axis together is gathered whole over both
        (the reference's GSPMD gathers it so), and is not the returned
        dim.  The dims in ``keep`` stay the rank's shard, whatever axes
        split them (the experts and their d_ff under GSPMD expert
        parallelism, ``models/moe.py``), and are never the returned dim.
        ``glu``: the last dim is a GLU's (gate | up), its shard the
        paired one (``sharding.shard_leaf``).

        A gather over a batch axis is FSDP's: its ranks hold other rows,
        so each one's gradient is a partial, reduce-scattered.  Over any
        other axis (``model``, or a data axis the batch does not take)
        the ranks compute the same from the whole leaf, and each keeps
        its chunk of its own gradient."""
        shape = tuple(shape)
        spec = sharding.spec_of(name, shape)
        want = sharding.local_shape(self.mesh, shape, spec)
        if tuple(w.shape) != want:
            raise ValueError(f"{name}: a leaf of {tuple(w.shape)} where "
                             f"the rank's shard of {shape} under the rules "
                             f"is {want}")
        model_dim = None
        for d, entry in enumerate(spec):
            names = sharding.axis_names(entry)
            if d in keep or not names:
                continue
            if names == ("model",):
                model_dim = d if self.model > 1 else None
                continue
            w = self._gather(w, d, names, glu and d == len(shape) - 1,
                             shape[d])
        return w, model_dim

    def _gather(self, w, d: int, names, glu: bool, whole: int):
        """``w`` gathered whole along dim ``d`` over ``names`` (minor
        first, the rank's block data major), ``param``'s autograd pairs;
        ``glu``: in (gate | up) pairs where the shard is paired."""
        n = math.prod(self.mesh.shape[a] for a in names)
        pairs = glu and sharding.glu_paired(whole, n)
        if pairs:
            w = w.unflatten(d, (2, w.shape[d] // 2))
        for a in reversed(names):                  # minor axis first
            if self.mesh.shape[a] == 1:
                continue
            gather = (collectives.gather_from_group if a in self.batch_axes
                      else collectives.gather_to_whole)
            w = gather(w, self.group(a), d + pairs)
        return w.flatten(d, d + 1) if pairs else w

    def splits_model(self, name: str, shape) -> bool:
        """Whether the rules split the leaf over ``model`` at all (alone
        or with another axis)."""
        return self.model > 1 and any(
            "model" in sharding.axis_names(e)
            for e in sharding.spec_of(name, tuple(shape)))

    def reshard(self, w: torch.Tensor, dim: Optional[int],
                want: Optional[int], glu: bool = False) -> torch.Tensor:
        """``w`` (from ``param``: its ``model`` shard along ``dim``, or
        whole) as the rank's ``model`` shard along ``want``, or whole
        where ``want`` is None: the form a block runs in where the rules
        place its leaf otherwise.  The shard is gathered whole
        (``param``'s gather over ``model``); a shard cut from a whole leaf takes the
        region's gradient share (``whole_in_region``), so that each
        rank's gradient of the whole leaf is the sum of the ranks'.
        ``glu``: the last dim is (gate | up), cut and gathered in pairs
        (``sharding.glu_paired``)."""
        if dim == want or self.model == 1:
            return w
        last = w.ndim - 1
        if dim is not None:
            w = self._gather(w, dim, ("model",), glu and dim == last,
                             w.shape[dim] * self.model)
        if want is None:
            return w
        w = self.whole_in_region(w)
        pairs = glu and want == last
        if pairs:
            w = w.unflatten(want, (2, w.shape[want] // 2))
        n = w.shape[want + pairs] // self.model
        w = w.narrow(want + pairs, self.rank * n, n)
        return w.flatten(want, want + 1) if pairs else w

    # -- regions over ``model`` ---------------------------------------------
    def begin(self, seq_len: int) -> None:
        """Start a pass over ``seq_len`` tokens: whether the residual
        stream between blocks holds the rank's share of the sequence
        (Megatron-SP: the rules map ``seq`` to ``model``, whose ranks
        divide it).  That holds until the next pass begins: through the
        loss, the backward and remat's recompute."""
        self.seq = self.shards(seq_len)

    def shards(self, seq_len: int) -> bool:
        """Whether a stream of ``seq_len`` tokens holds the rank's share
        of the sequence between blocks: the rules map ``seq`` to
        ``model``, whose ranks divide it (else it runs whole, as the
        reference's ``spec_for`` falls back)."""
        return (self._seq_rule and self.model > 1
                and seq_len % self.model == 0)

    def seq_rows(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The rank's share of ``t``'s whole sequence (dim ``dim``) where
        the stream holds shares; ``t`` as it is otherwise."""
        if not self.seq:
            return t
        n = t.shape[dim] // self.model
        return t.narrow(dim, self.rank * n, n)

    def gather_stream(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` of the residual stream whole along the sequence on every
        rank where the stream holds shares, gathered once for a block
        whose ranks all compute the same from it before its column
        entries (``whole_in_region``, not ``enter``): a token shift or a
        conv that reads across shares.  Its gradient is the rank's share
        of that whole one."""
        return self.gather_whole(x, 1) if self.seq else x

    def whole_sequence(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` of the residual stream, whole along the sequence (the
        rank's shares gathered when the pass shards it); the stream is
        whole from here on (a prefill's last position)."""
        if not self.seq:
            return x
        self.seq = False
        return self.gather_model(x, 1)

    def enter(self, x: torch.Tensor):
        """``x`` into a region whose ranks each compute a share of what
        follows: gathered along the sequence where the stream holds
        shares (the gradient reduce-scattered), else as it is (the
        gradient all-reduced)."""
        if self.model == 1:
            return x
        if self.seq:
            return collectives.gather_from_group(x, self.group("model"), 1)
        return collectives.copy_to_group(x, self.group("model"))

    def exit(self, y: torch.Tensor):
        if self.model == 1:
            return y
        if self.seq:
            return collectives.scatter_to_group(y, self.group("model"), 1)
        return collectives.reduce_from_group(y, self.group("model"))

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over ``model`` (a sum whose terms lie on the
        ranks, whatever the stream holds); the gradient passed on."""
        if self.model == 1:
            return t
        return collectives.reduce_from_group(t, self.group("model"))

    def whole_in_region(self, t):
        if t is None or self.model == 1:
            return t
        return collectives.copy_to_group(t, self.group("model"))

    def gather_model(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` along ``dim`` over ``model``; the gradient
        reduce-scattered."""
        if self.model == 1:
            return t
        return collectives.gather_from_group(t, self.group("model"), dim)

    def gather_whole(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` along ``dim`` over ``model``, where every
        rank then computes the same from it; the gradient is the rank's
        chunk of its own."""
        if self.model == 1:
            return t
        return collectives.gather_to_whole(t, self.group("model"), dim)

    def reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``t`` over ``model``, no gradient."""
        t = t.detach().clone()
        if self.model > 1:
            collectives.all_reduce(t, self.group("model"), op="max")
        return t

    def cache_shard(self, cfg, leaf: torch.Tensor) -> CacheShard:
        """Where this rank's cache leaf ``leaf`` lies in the whole cache
        (``sharding.cache_placement``).  Positions shared out over
        ``model`` alone are attended in place and merged; over other
        axes too, gathered first (``CacheShard.gather``)."""
        whole, spec = sharding.cache_placement(leaf, cfg, self.mesh)
        names, heads = (tuple(a for a in sharding.axis_names(spec[d])
                              if self.mesh.shape[a] > 1) for d in (3, 2))
        split = names == ("model",)
        start = sharding.block_index(self.mesh, names) * leaf.shape[3]
        return CacheShard(every_head=leaf.shape[2] == cfg.n_kv_heads,
                          start=start, length=whole[3], split=split,
                          gather=() if split else names, heads=heads)

    def gather_over(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """Every rank's ``t`` along ``dim`` over ``axes`` (minor first:
        their block, major first), no gradient (a serving cache)."""
        for a in reversed(axes):
            t = collectives.all_gather(t, self.group(a), dim)
        return t

    # -- recurrent state ---------------------------------------------------
    def _rows(self, n: int) -> "tuple[str, ...]":
        """The axes a batch of ``n`` rows is split over (``local_batch``)."""
        spec = logical.spec_for((n,), ("batch",))
        return tuple(a for a in sharding.axis_names(spec[0])
                     if self.mesh.shape[a] > 1)

    def _state_spec(self, cfg, leaf, batch_dim: int):
        """(the leaf's spec, the axes its rows are split over, the axes
        the batch's rows are)."""
        whole, spec = sharding.cache_placement(leaf, cfg, self.mesh)
        held = tuple(a for a in sharding.axis_names(spec[batch_dim])
                     if self.mesh.shape[a] > 1)
        return spec, held, self._rows(whole[batch_dim])

    def read_state(self, cfg, leaf: torch.Tensor, batch_dim: int,
                   chan_dim: int, split: bool = True) -> torch.Tensor:
        """A copy of a state leaf of the cache (in the reference's form,
        its channels whole over ``model``; placed by
        ``sharding.shard_cache``) at the rank's rows, as its batch holds
        them, and its ``model`` share of the channels (dim ``chan_dim``)
        where the block runs on it (``split``), else every channel.
        A dim the form splits otherwise (an unstacked leaf's channels,
        which the reference splits over the batch axes) is gathered."""
        spec, held, rows = self._state_spec(cfg, leaf, batch_dim)
        x = leaf
        for d, entry in enumerate(spec):
            if d == batch_dim and held == rows:
                continue
            for a in reversed(sharding.axis_names(entry)):
                if self.mesh.shape[a] > 1:
                    x = collectives.all_gather(x, self.group(a), d)
        if rows != held:
            n = x.shape[batch_dim] // math.prod(self.mesh.shape[a]
                                                for a in rows)
            x = x.narrow(batch_dim, sharding.block_index(self.mesh, rows) * n,
                         n)
        if self.model > 1 and split:
            c = x.shape[chan_dim] // self.model
            x = x.narrow(chan_dim, self.rank * c, c)
        return x.clone(memory_format=torch.contiguous_format)

    def write_state(self, cfg, leaf: torch.Tensor, new: torch.Tensor,
                    batch_dim: int, chan_dim: int,
                    split: bool = True) -> None:
        """Write ``new`` (``read_state``'s form: the rank's rows and
        channels, every channel where not ``split``) into the cache's
        leaf: gathered over ``model`` along the channels, over the batch
        axes along the rows where the leaf holds them all, then the
        leaf's shard of it."""
        spec, held, rows = self._state_spec(cfg, leaf, batch_dim)
        x = new
        if self.model > 1 and split:
            x = collectives.all_gather(x, self.group("model"), chan_dim)
        if rows != held:
            for a in reversed(rows):
                x = collectives.all_gather(x, self.group(a), batch_dim)
            x = sharding.shard_leaf(x, spec, self.mesh)
        else:
            x = sharding.shard_leaf(x, spec[:batch_dim] + (None,)
                                    + spec[batch_dim + 1:], self.mesh)
        leaf.copy_(x)

    # -- the batch and the optimizer ----------------------------------------
    def sum_over_batch(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the batch axes, in place, no gradient."""
        for a in self.batch_axes:
            if self.mesh.shape[a] > 1:
                collectives.all_reduce(t, self.group(a))
        return t

    def reduce_gradients(self, grads, specs) -> None:
        """All-reduce, over each batch axis a leaf's spec does not name,
        its gradient (the data-parallel sum; an FSDP leaf's was
        reduce-scattered over its data axes in the backward)."""
        for g, spec in zip(grads, specs):
            named = {a for e in spec for a in sharding.axis_names(e)}
            for a in self.batch_axes:
                if self.mesh.shape[a] > 1 and a not in named:
                    collectives.all_reduce(g, self.group(a))

    def global_norm(self, grads, specs) -> torch.Tensor:
        """The norm of the whole gradient from the local shards: each
        leaf's squares summed where this rank is the first of the ranks
        that hold the same shard, then all-reduced over the mesh."""
        coord = dict(zip(self.mesh.axis_names, self.mesh.coordinate))
        total = torch.zeros((), dtype=torch.float32,
                            device=grads[0].device if grads else None)
        for g, spec in zip(grads, specs):
            named = {a for e in spec for a in sharding.axis_names(e)}
            if all(coord[a] == 0 for a in coord if a not in named):
                total = total + torch.sum(torch.square(g.to(torch.float32)))
        for a in self.mesh.axis_names:
            if self.mesh.shape[a] > 1:
                collectives.all_reduce(total, self.group(a))
        return torch.sqrt(total)


def current() -> Optional[Placement]:
    """The placement of the active rules when this process is a rank of
    their mesh; None without rules, or on an abstract mesh (whose leaves
    are whole)."""
    if not logical._ACTIVE:
        return None
    entry = logical._ACTIVE[-1]
    mesh, rules, placed = entry
    if placed is None:
        if not mesh.has_rank:
            return None
        placed = entry[2] = Placement(mesh, rules)
    return placed


def begin_pass(seq_len: int) -> Optional[Placement]:
    """The placement of the active rules (``current``), its pass over
    ``seq_len`` tokens begun (``Placement.begin``)."""
    pl = current()
    if pl is not None:
        pl.begin(seq_len)
    return pl


@contextlib.contextmanager
def holding(seq: bool):
    """Within: the current placement's stream holds the rank's share of
    the sequence where ``seq`` says (a second stream of a pass, decided
    by ``Placement.shards``); the pass's own after.  Wrap the body that
    remat recomputes, so that its recompute holds the same."""
    pl = current()
    if pl is None:
        yield
        return
    before, pl.seq = pl.seq, seq
    try:
        yield
    finally:
        pl.seq = before


def seq_sharded() -> bool:
    """Whether the current pass holds the rank's share of the sequence."""
    pl = current()
    return pl is not None and pl.seq
