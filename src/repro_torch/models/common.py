"""Shared layers for the port's model zoo.

Every matmul in this file goes through ``core.fusion`` (``cute_matmul`` /
``linear``) so the paper's fused-epilogue contract applies framework-wide.
Attention offers three implementations (``cfg.backend``):

* ``kernel`` — the hand-written CUDA flash kernel (``kernels/attention``);
  its plain version on CPU tensors.  The reference's ``pallas``.
* ``torch``  — chunked online-softmax in plain tensor ops, a Python loop
  over KV blocks (``cfg.attn_pv_bf16`` rounds P·V's operands to bf16).
  The reference's ``xla``.
* ``dense``  — the reference oracle, for tiny smoke tests only.

The reference's ``distributed.logical.constrain`` sharding annotations
are dropped: its GSPMD moves the data they ask for.  Under a mesh this
process is a rank of, the projections, attention, the embedding and the
logits run on the rank's shards instead, moving the data themselves
(``distributed.tensor_parallel``): column-parallel projections behind
the region's entry, row-parallel ones before its exit, the embedding
vocab-parallel, the logits column-parallel over the vocabulary.
Under sequence parallelism a leaf the rules keep whole acts on the rank's
share of the sequence where it works row by row (a norm, an MLP, the
embedding's lookup: ``stream_leaf``), and on the gathered stream where it
mixes positions (attention), every rank computing every row and keeping
its own.
"""

from __future__ import annotations

import math

import torch

from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core import tree
from repro_torch.core.fusion import linear
from repro_torch.distributed import sharding
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels.attention.ops import (decode_attention,
                                               decode_attention_merge,
                                               decode_attention_partial)
from repro_torch.kernels.matmul import ops as mm_ops
from repro_torch.models.base import ArchConfig


# ---------------------------------------------------------------------------
# Initializers (same distributions as the reference; torch's generator
# gives other numbers than jax.random, so parity tests convert weights).
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype, in_axis: int = 0,
               device=None):
    fan_in = shape[in_axis]
    x = torch.randn(shape, generator=gen, device=device) / math.sqrt(fan_in)
    return x.to(dtype)


def embed_init(gen: torch.Generator, shape, dtype, device=None):
    return (torch.randn(shape, generator=gen, device=device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Parameter trees: dicts of tensors, stacked on a leading layer axis.
# ---------------------------------------------------------------------------

def stack_init(make, n: int):
    """``n`` trees from ``make()`` stacked on a leading axis, filled one at
    a time so that only one tree's temporaries exist besides the stack."""
    first = make()
    stack = tree.tree_map(lambda x: torch.empty((n, *x.shape), dtype=x.dtype,
                                                device=x.device), first)
    slabs = tree.leaves(stack)

    def fill(i, one):
        for s, x in zip(slabs, tree.leaves(one)):
            s[i].copy_(x)
    fill(0, first)
    del first
    for i in range(1, n):
        fill(i, make())
    return stack


def layer(stacked, i: int):
    """Layer ``i`` of a stacked tree, as views."""
    return tree.tree_map(lambda x: x[i], stacked)


# ---------------------------------------------------------------------------
# Norms.
# ---------------------------------------------------------------------------

def rmsnorm(x, w, eps: float = 1e-6, unit_offset: bool = False):
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    scale = (1.0 + w.float()) if unit_offset else w.float()
    return (y * scale).to(dt)


def layernorm(x, w, b, eps: float = 1e-5):
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


def groupnorm_heads(x, w, b, n_heads: int, eps: float = 64e-5):
    """RWKV ln_x: GroupNorm over head groups of the flattened channel dim."""
    dt = x.dtype
    *lead, c = x.shape
    xf = x.float().reshape(*lead, n_heads, c // n_heads)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(*lead, c)
    return (y * w.float() + b.float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE.
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 1e4):
    """x: (B, H, S, D); positions: (S,) or (B, S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)             # (D/2,)
    angles = positions.float()[..., None] * freqs      # (..., S, D/2)
    if angles.dim() == 2:                              # (S, D/2) -> broadcast
        angles = angles[None, None]
    else:                                              # (B, S, D/2)
        angles = angles[:, None]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention.
# ---------------------------------------------------------------------------

def attention_chunked(q, k, v, *, sm_scale, causal=True, window=0,
                      softcap=0.0, q_start=0, chunk=1024, pv_bf16=False):
    """Online-softmax attention over KV chunks in plain tensor ops: the
    counterpart of the reference's ``attention_xla_chunked``.

    q: (B, H, Sq, D); k/v: (B, Hkv, Sk, D).  Peak live memory is one
    (B, H, Sq, chunk) score block instead of (B, H, Sq, Sk).
    ``pv_bf16``, as in the reference, rounds the probability block and V
    to bf16 for the P·V product (fp32 accumulation): the rounding K2's
    tensor-core tile makes in bf16.

    Where autograd tracks the call, each chunk step runs under a
    non-reentrant ``checkpoint``, as the reference remats its scan body:
    the forward keeps only a step's inputs (the running max, sum and
    accumulator, and views of K and V), and the backward recomputes one
    chunk's score and probability blocks at a time.
    """
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = h // hkv
    chunk = min(chunk, sk)
    qf = (q.float() * sm_scale).reshape(b, hkv, group * sq, d)  # GQA rows
    qpos = q_start + torch.arange(sq, device=q.device).repeat(group)

    rows = group * sq
    m = torch.full((b, hkv, rows, 1), -1e30, device=q.device)
    l = torch.zeros((b, hkv, rows, 1), device=q.device)
    acc = torch.zeros((b, hkv, rows, d), device=q.device)

    def step(start, qf, kj, vj, m, l, acc):
        kj, vj = kj.float(), vj.float()
        s = torch.einsum("bnqd,bnkd->bnqk", qf, kj)
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        kpos = start + torch.arange(kj.shape[2], device=q.device)
        mask = torch.ones((rows, kj.shape[2]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window > 0:
            mask &= (qpos[:, None] - kpos[None, :]) < window
        s = torch.where(mask, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        if pv_bf16:     # bf16 products are exact in fp32
            p, vj = (x.to(torch.bfloat16).float() for x in (p, vj))
        acc = alpha * acc + torch.einsum("bnqk,bnkd->bnqd", p, vj)
        return m_new, l, acc

    tracked = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    for start in range(0, sk, chunk):
        args = (start, qf, k[:, :, start:start + chunk],
                v[:, :, start:start + chunk], m, l, acc)
        if tracked:
            m, l, acc = checkpoint(step, *args, use_reentrant=False)
        else:
            m, l, acc = step(*args)
    l = torch.where(l == 0.0, 1.0, l)
    out = (acc / l).reshape(b, h, sq, d)
    return out.to(q.dtype)


def attention(cfg: ArchConfig, q, k, v, *, causal=True, window=0,
              softcap=None, q_start=0, sm_scale=None):
    """Backend-dispatching attention. q: (B, H, S, D), k/v: (B, Hkv, S, D)."""
    sm_scale = cfg.sm_scale if sm_scale is None else sm_scale
    softcap = cfg.attn_softcap if softcap is None else softcap
    if cfg.backend == "kernel":
        from repro_torch.kernels.attention.ops import flash_attention
        return flash_attention(q, k, v, sm_scale=sm_scale, causal=causal,
                               window=window, softcap=softcap,
                               q_start=q_start, cost_chunk=cfg.attn_chunk)
    if cfg.backend == "dense":
        from repro_torch.kernels.attention.ref import attention_ref
        return attention_ref(q, k, v, sm_scale=sm_scale, causal=causal,
                             window=window, softcap=softcap, q_start=q_start)
    if cfg.backend != "torch":
        raise ValueError(f"unknown attention backend {cfg.backend!r}; use "
                         "'kernel', 'torch' or 'dense'")
    return attention_chunked(q, k, v, sm_scale=sm_scale, causal=causal,
                             window=window, softcap=softcap,
                             q_start=q_start, chunk=cfg.attn_chunk,
                             pv_bf16=cfg.attn_pv_bf16)


# ---------------------------------------------------------------------------
# Attention block parameters + apply (GQA, optional bias / qk-norm / RoPE).
# ---------------------------------------------------------------------------

def attn_init(cfg: ArchConfig, gen: torch.Generator, device=None):
    d = cfg.d_model
    kw = dict(device=device)
    p = {
        "wq": dense_init(gen, (d, cfg.q_dim), cfg.dtype, **kw),
        "wk": dense_init(gen, (d, cfg.kv_dim), cfg.dtype, **kw),
        "wv": dense_init(gen, (d, cfg.kv_dim), cfg.dtype, **kw),
        "wo": dense_init(gen, (cfg.q_dim, d), cfg.dtype, in_axis=1, **kw),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.q_dim,), dtype=cfg.dtype, **kw)
        p["bk"] = torch.zeros((cfg.kv_dim,), dtype=cfg.dtype, **kw)
        p["bv"] = torch.zeros((cfg.kv_dim,), dtype=cfg.dtype, **kw)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((cfg.head_dim,), dtype=cfg.dtype, **kw)
        p["k_norm"] = torch.ones((cfg.head_dim,), dtype=cfg.dtype, **kw)
    return p


def qkv_project(cfg: ArchConfig, p, x, positions, every_kv: bool = False,
                kv_x=None):
    """x: (B, S, d) -> q (B, H, S, hd), k/v (B, Hkv, S', hd) with RoPE;
    K and V are projected from ``kv_x`` (B, S', d) where given (a
    cross-attention's encoder output), else from ``x``.  Under a mesh,
    the rank's heads (``_qkv_placed``); ``every_kv``, K and V of every KV
    head however few the rank's q heads read.  A cross-attention's
    projections take no route (``_route``)."""
    pl = tp.current()
    if pl is not None:
        return _qkv_placed(cfg, pl, p, x, positions, every_kv, kv_x)
    return _qkv(cfg, x, (p["wq"], p["wk"], p["wv"]),
                (p.get("bq"), p.get("bk"), p.get("bv")),
                (p.get("q_norm"), p.get("k_norm")), positions, kv_x)


def _route(cfg: ArchConfig, cross: bool) -> "str | None":
    """A q/K/V projection's matmul route: ``_mm_backend``'s, but none
    for a cross-attention's, which resolves it through the tuned
    dispatch by shape, as the reference's cross projections do."""
    return None if cross else _mm_backend(cfg)


def _qkv(cfg: ArchConfig, x, w, bias, norms, positions, kv_x=None):
    b, s, _ = x.shape
    src = x if kv_x is None else kv_x
    route = _route(cfg, kv_x is not None)
    q, k, v = (linear(xi, wi, bi, backend=route)
               for xi, wi, bi in zip((x, src, src), w, bias))
    q = q.reshape(b, s, -1, cfg.head_dim).transpose(1, 2)
    k = k.reshape(b, src.shape[1], -1, cfg.head_dim).transpose(1, 2)
    v = v.reshape(b, src.shape[1], -1, cfg.head_dim).transpose(1, 2)
    if cfg.qk_norm:
        q = rmsnorm(q, norms[0], cfg.rms_eps)
        k = rmsnorm(k, norms[1], cfg.rms_eps)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def rank_heads(cfg: ArchConfig, pl, r=None) -> "tuple[int, int, int, int]":
    """(first q head, q heads, first KV head, KV heads) the rank (``r`` of
    ``model``, this one's where None) attends with under ``pl``, where
    ``wq``'s columns are split over ``model``: its own q heads where they
    divide ``model``, else (gemma2-2b's 8 on 16) every head; the KV heads
    they read (where the q heads straddle KV groups, deepseek-67b's 6 q
    heads of 2 KV groups on 3 ranks, the KV heads of every group they
    touch: ``kv_of_q``)."""
    m, r = pl.model, pl.rank if r is None else r
    gather_q = cfg.n_heads % m != 0
    hq = cfg.n_heads if gather_q else cfg.n_heads // m
    q0 = 0 if gather_q else r * hq
    group = cfg.n_heads // cfg.n_kv_heads
    if hq % group == 0:
        return q0, hq, q0 // group, hq // group
    if group % hq == 0:
        return q0, hq, q0 // group, 1
    k0 = q0 // group
    return q0, hq, k0, (q0 + hq - 1) // group + 1 - k0


def kv_of_q(cfg: ArchConfig, q0: int, hq: int):
    """The KV head each of the q heads ``[q0, q0 + hq)`` reads, where
    they straddle KV groups; None where they hold whole groups or share
    one KV head (``attention`` groups them itself)."""
    group = cfg.n_heads // cfg.n_kv_heads
    if hq % group == 0 or group % hq == 0:
        return None
    return [(q0 + i) // group for i in range(hq)]


def attn_split(cfg: ArchConfig, pl) -> bool:
    """Whether the rank runs the attention block on its heads (``wq``,
    ``wk`` and ``wv`` by columns, ``wo`` by rows: ``_qkv_placed``,
    ``attn_out``): where the rules split any of the four leaves over
    ``model`` and ``model`` divides ``wq``'s columns.  Leaves placed
    otherwise take that form (``Placement.reshard``).  Else every rank
    runs every head on the whole leaves."""
    if pl.model == 1 or cfg.q_dim % pl.model:
        return False
    d = cfg.d_model
    return any(pl.splits_model(k, shape) for k, shape in (
        ("wq", (d, cfg.q_dim)), ("wk", (d, cfg.kv_dim)),
        ("wv", (d, cfg.kv_dim)), ("wo", (cfg.q_dim, d))))


def _qkv_placed(cfg: ArchConfig, pl, p, x, positions, every_kv=False,
                kv_x=None):
    """The rank's q heads and the KV heads they read, from its shards.

    ``wq`` holds the rank's q columns.  Where the q heads divide
    ``model`` those are whole heads; else (gemma2-2b's 8 on 16) the
    columns are all-gathered and every rank attends with every head, as
    GSPMD replicates them (``attn_out`` then takes the rank's rows).
    Where the rank's KV heads are the ones its q heads read, K and V come
    from its own columns; else (yi-6b's 4 KV heads on 16) the KV weights
    are gathered over ``model`` and the rank computes the KV heads its q
    heads read, or, with ``every_kv`` (a cache that holds every KV head
    on each rank: ``_attend_placed``), every KV head in one product, as
    the reference's one matmul does.  ``kv_x`` (a cross-attention's
    encoder output, whole on every rank) enters the region beside ``x``.
    Leaves the rules place otherwise (``wq`` whole or by rows, ``wk`` and
    ``wv`` by rows) are brought to that form first (``attn_split``).
    Where the rules keep the attention's leaves whole, under sequence
    parallelism the stream is gathered and every rank computes every
    head (``attn_out`` keeps its rows)."""
    d, hd = cfg.d_model, cfg.head_dim
    wq, qd = pl.param(p["wq"], "wq", (d, cfg.q_dim))
    wk, kd = pl.param(p["wk"], "wk", (d, cfg.kv_dim))
    wv, vd = pl.param(p["wv"], "wv", (d, cfg.kv_dim))
    bias = (p.get("bq"), p.get("bk"), p.get("bv"))
    norms = (p.get("q_norm"), p.get("k_norm"))
    if not attn_split(cfg, pl):                       # whole on every rank
        wq, wk, wv = (pl.reshard(w_, dim, None)
                      for w_, dim in ((wq, qd), (wk, kd), (wv, vd)))
        if pl.seq:      # every head over the gathered stream; every leaf's
            x = pl.gather_model(x, 1)  # gradient a share (attn_out's rows)
            kv_x, wq, wk, wv = (pl.whole_in_region(t)
                                for t in (kv_x, wq, wk, wv))
            bias, norms = (tuple(pl.whole_in_region(t) for t in ts)
                           for ts in (bias, norms))
        return _qkv(cfg, x, (wq, wk, wv), bias, norms, positions, kv_x)
    wq = pl.reshard(wq, qd, 1)
    kv = kd if kd == vd and kd in (1, None) else None
    wk, wv = pl.reshard(wk, kd, kv), pl.reshard(wv, vd, kv)
    kd = kv
    m, r = pl.model, pl.rank
    h = pl.enter(x)
    src = h if kv_x is None else pl.whole_in_region(kv_x)
    q0, hq, k0, hk = rank_heads(cfg, pl)
    if every_kv:
        k0, hk = 0, cfg.n_kv_heads
    kv_local = cfg.n_kv_heads // m
    own = (kd == 1 and cfg.n_kv_heads % m == 0
           and (k0, hk) == (r * kv_local, kv_local))
    bk, bv = (pl.whole_in_region(b_) for b_ in bias[1:])
    if own:
        span = slice(r * kv_local * hd, (r + 1) * kv_local * hd)
    else:
        span = slice(k0 * hd, (k0 + hk) * hd)
        wk, wv = ((pl.gather_model(w_, 1) if kd == 1
                   else pl.whole_in_region(w_))[:, span] for w_ in (wk, wv))
    bk, bv = (None if b_ is None else b_[span] for b_ in (bk, bv))
    route = _route(cfg, kv_x is not None)
    q = _q_columns(cfg, pl, h, wq, bias[0], hq, route)
    k = linear(src, wk, bk, backend=route)
    v = linear(src, wv, bv, backend=route)
    b, s, _ = h.shape
    q = q.reshape(b, s, hq, hd).transpose(1, 2)
    k = k.reshape(b, src.shape[1], hk, hd).transpose(1, 2)
    v = v.reshape(b, src.shape[1], hk, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = rmsnorm(q, pl.whole_in_region(norms[0]), cfg.rms_eps)
        k = rmsnorm(k, pl.whole_in_region(norms[1]), cfg.rms_eps)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    each = None if every_kv else kv_of_q(cfg, q0, hq)
    if each is not None:        # one KV head a q head, of the rank's
        idx = [j - k0 for j in each]
        k, v = k[:, idx], v[:, idx]
    return q, k, v


def _q_columns(cfg: ArchConfig, pl, h, wq, bq, hq: int, route):
    """The rank's q columns of ``h`` (inside the region), gathered over
    ``model`` where the rank attends with every head (``rank_heads``)."""
    cols = cfg.q_dim // pl.model
    bq = pl.whole_in_region(bq)
    bq = None if bq is None else bq[pl.rank * cols:(pl.rank + 1) * cols]
    q = linear(h, wq, bq, backend=route)
    if hq == cfg.n_heads:                   # every head: the columns gathered
        q = pl.gather_model(q, -1)
    return q


def cross_q_project(cfg: ArchConfig, p, x):
    """A cross-attention's q alone (B, H, S, hd), no RoPE: a decode step,
    whose K and V are cached.  Under a mesh, the rank's heads as
    ``qkv_project`` gives them."""
    pl = tp.current()
    route = _route(cfg, cross=True)
    if pl is None or not attn_split(cfg, pl):
        wq = p["wq"]
        if pl is not None:
            wq = pl.reshard(*pl.param(wq, "wq", (cfg.d_model, cfg.q_dim)),
                            None)
        q = linear(x, wq, p.get("bq"), backend=route)
    else:
        wq = pl.reshard(*pl.param(p["wq"], "wq", (cfg.d_model, cfg.q_dim)),
                        1)
        hq = rank_heads(cfg, pl)[1]
        q = _q_columns(cfg, pl, pl.enter(x), wq, p.get("bq"), hq, route)
    b, s, _ = x.shape
    return q.reshape(b, s, -1, cfg.head_dim).transpose(1, 2)


def self_attention(cfg: ArchConfig, p, h, positions, *, window: int,
                   kv_cache=None, cache_pos=None, shard=None):
    """Causal self-attention's context (B, H, S, hd) of ``h`` (B, S, d),
    the rank's heads under a mesh (``attn_out`` takes it).  ``kv_cache``
    (k, v) is written in place at ``cache_pos``: a decode step (one new
    token) attends over it, a prefill over the prompt.  ``shard`` (under
    a mesh) says where the rank's cache lies in the whole: a cache of
    every KV head goes through ``_attend_placed``; a cache of other KV
    heads than the rank computes, through ``held_heads``."""
    if shard is not None and shard.every_head:
        return _attend_placed(cfg, p, h, positions, window, kv_cache,
                              cache_pos, shard)
    q, k, v = qkv_project(cfg, p, h, positions)
    if kv_cache is None:
        return attention(cfg, q, k, v, causal=True, window=window)
    pl = tp.current()
    held = None if shard is None else held_heads(cfg, pl, shard, q,
                                                 kv_cache)
    if held is None:
        k_cache, v_cache = cache_update(*kv_cache, k, v, cache_pos)
    else:
        write_heads(pl, kv_cache, k, v, held, cache_pos)
    if q.shape[2] == 1:                          # decode: one new token
        if held is not None:
            k_cache, v_cache = read_heads(pl, shard, kv_cache, held)
        return decode_attention(q, k_cache, v_cache, cache_pos + 1,
                                sm_scale=cfg.sm_scale, window=window,
                                softcap=cfg.attn_softcap)
    return attention(cfg, q, k, v, causal=True, window=window)


def held_heads(cfg: ArchConfig, pl, shard, q, kv_cache):
    """Where the ranks' caches hold other KV heads than they compute for
    their q heads (the rules share the cache's KV heads out over other
    axes than ``model`` alone, ``shard.heads``, or the ranks compute
    every head): (the KV head each of this rank's K and V heads is, those
    of every rank of ``model`` in its order where each computes its share
    (None where each computes every head), the first head its cache
    holds); else None.  Decided alike on every rank, as the gathers of
    ``write_heads`` and ``read_heads`` need."""
    def ids(r):
        q0, hq, k0, hk = rank_heads(cfg, pl, r)
        return kv_of_q(cfg, q0, hq) or list(range(k0, k0 + hk))
    if q.shape[1] == cfg.n_heads:                # every q head on the rank
        mine, every = list(range(cfg.n_kv_heads)), None
    else:
        every = [i for r in range(pl.model) for i in ids(r)]
        mine = ids(pl.rank)
    n = kv_cache[0].shape[1]
    h0 = sharding.block_index(pl.mesh, shard.heads) * n
    if shard.heads == ("model",) and mine == list(range(h0, h0 + n)):
        return None
    return mine, every, h0


def write_heads(pl, kv_cache, k, v, held, pos: int, start: int = 0,
                length: "int | None" = None):
    """Write each of the cache's KV heads ``[h0, h0 + n)`` at ``pos``
    (``cache_update``) from ``k`` and ``v`` (the rank's heads, ``held``
    as ``held_heads`` gives it), every rank's gathered over ``model``
    where each computes its share (a serving cache: no gradient)."""
    ids, every, h0 = held
    if every is not None:
        k, v = (pl.gather_over(t, ("model",), 1) for t in (k, v))
        ids = every
    for j in range(h0, h0 + kv_cache[0].shape[1]):
        i, c = ids.index(j), slice(j - h0, j - h0 + 1)
        cache_update(kv_cache[0][:, c], kv_cache[1][:, c], k[:, i:i + 1],
                     v[:, i:i + 1], pos, start, length)


def read_heads(pl, shard, kv_cache, held):
    """The cache's K and V at the KV heads the rank reads (``held`` as
    ``held_heads`` gives it): every head gathered over the axes that
    share them out (a serving cache: no gradient)."""
    return tuple(pl.gather_over(c, shard.heads, 1)[:, held[0]]
                 for c in kv_cache)


def _attend_placed(cfg: ArchConfig, p, h, positions, window, kv_cache,
                   cache_pos, shard):
    """Attention on a rank whose cache holds every KV head (the
    reference's cache on a model axis its KV heads do not divide), at
    positions ``[shard.start, shard.start + S)`` of the whole.

    The rank computes K and V of every KV head (``qkv_project`` with
    ``every_kv``) and writes the new rows that fall in its positions: a
    prefill its share of the prompt, a decode step the new token where
    its rank holds ``cache_pos``.  A prefill attends with the rank's q
    heads over the whole prompt (K2), as without a cache.  A decode step
    whose cache holds every position attends so over it; where the
    positions are shared out over ``model`` (``shard.split``), each rank
    attends with every q head over its own positions (``split_decode``);
    where other axes share them out, over every position, gathered
    (``cache_view``).  Every rank returns every head's context;
    ``attn_out`` takes its rows.  Under sequence parallelism a prefill's
    K and V come from the gathered prompt, so that the rank writes the
    rows of its cache positions as without it."""
    pl = tp.current()
    q, k, v = qkv_project(cfg, p, h, positions, every_kv=True)
    read = kv_read(cfg, pl, q)
    k_cache, v_cache = cache_update(*kv_cache, k, v, cache_pos,
                                    shard.start, shard.length)
    if q.shape[2] > 1:                           # prefill writes + attends
        return attention(cfg, q, k[:, read], v[:, read], causal=True,
                         window=window)
    kw = dict(sm_scale=cfg.sm_scale, window=window, softcap=cfg.attn_softcap)
    if not shard.split:
        k_cache, v_cache = cache_view(pl, shard, k_cache, v_cache)
        return decode_attention(q, k_cache[:, read], v_cache[:, read],
                                cache_pos + 1, **kw)
    return split_decode(cfg, pl, q, k_cache, v_cache, cache_pos + 1,
                        shard.start, **kw)


def cache_view(pl, shard, *caches):
    """The cache tensors (B, Hkv, S, D) a decode step attends over: as
    they are, or every position where axes other than ``model`` share
    them out (``CacheShard.gather``)."""
    if pl is None or not shard.gather:
        return caches
    return tuple(pl.gather_over(c, shard.gather, 2) for c in caches)


def kv_read(cfg: ArchConfig, pl, q):
    """The KV heads (of every one) that the rank's q heads read: a
    slice, or one index a q head where they straddle KV groups."""
    if q.shape[1] == cfg.n_heads:                # every q head on the rank
        return slice(0, cfg.n_kv_heads)
    q0, hq, k0, hk = rank_heads(cfg, pl)
    each = kv_of_q(cfg, q0, hq)
    return slice(k0, k0 + hk) if each is None else each


def split_decode(cfg: ArchConfig, pl, q, k_cache, v_cache, cache_len,
                 start: int, **kw):
    """Decode attention over a cache whose positions are shared out over
    ``model``: each rank attends with every q head (gathered over
    ``model`` where it holds its own) over its positions ``[start, start
    + S)``, in fp32, and the ranks combine the row max, the sum of
    exponentials and P·V (``decode_attention_merge``: one max and one sum
    all-reduced).  ``kw``: ``decode_attention``'s masks."""
    if q.shape[1] != cfg.n_heads:
        q = pl.gather_model(q, 1)
    m, l, acc = decode_attention_partial(q, k_cache, v_cache, cache_len,
                                         start=start, **kw)
    return decode_attention_merge(m, l, acc, reduce_max=pl.reduce_max,
                                  reduce_sum=pl.reduce, dtype=q.dtype)


def attn_out(cfg: ArchConfig, p, ctx):
    """ctx: (B, H, S, hd) -> (B, S, d).  Under a mesh, the rank's rows of
    ``wo`` (row parallel), then the region's exit; ``wo`` whole where
    every rank runs every head (``attn_split``), under sequence
    parallelism on the rank's share of the sequence of a context every
    rank computed whole (``_qkv_placed``)."""
    b, h, s, hd = ctx.shape
    ctx = ctx.transpose(1, 2).reshape(b, s, h * hd)
    pl = tp.current()
    if pl is None:
        return linear(ctx, p["wo"], backend=_mm_backend(cfg))
    wo, od = pl.param(p["wo"], "wo", (cfg.q_dim, cfg.d_model))
    if not attn_split(cfg, pl):
        wo = pl.reshard(wo, od, None)
        if pl.seq:
            ctx, wo = pl.seq_rows(ctx), pl.whole_in_region(wo)
        return linear(ctx, wo, backend=_mm_backend(cfg))
    wo = pl.reshard(wo, od, 0)
    rows = cfg.q_dim // pl.model
    if h * hd == cfg.q_dim:                      # every head: the rank's
        ctx = ctx[..., pl.rank * rows:(pl.rank + 1) * rows]
    return row_parallel(cfg, pl, ctx, wo)


def row_parallel(cfg: ArchConfig, pl, x, w):
    """A row-parallel projection's region exit.  The ranks' partial
    products are summed in fp32 and rounded once to ``x``'s dtype, as one
    rank's K1 accumulates the whole product: bf16 partials would round
    twice."""
    y = linear(x, w, out_dtype=torch.float32, backend=_mm_backend(cfg))
    return pl.exit(y).to(x.dtype)


def _mm_backend(cfg: ArchConfig) -> str:
    # The zoo's matmul route is a registry lookup:
    # repro_torch.backend.set_default_matmul_backend re-routes every
    # projection here.  cfg.backend routes *attention*.
    from repro_torch.backend import matmul_backend_string
    return matmul_backend_string()


# ---------------------------------------------------------------------------
# MLP.
# ---------------------------------------------------------------------------

def mlp_init(cfg: ArchConfig, gen: torch.Generator, device=None):
    d, ff = cfg.d_model, cfg.d_ff
    mult = 2 if cfg.mlp_glu else 1
    return {
        "wi": dense_init(gen, (d, mult * ff), cfg.dtype, device=device),
        "wo": dense_init(gen, (ff, d), cfg.dtype, in_axis=1, device=device),
    }


def mlp_apply(cfg: ArchConfig, p, x):
    """Under a mesh, ``wi``'s rank columns (a GLU's gate and up halves
    paired, ``sharding.shard_leaf``; a plain MLP's contiguous) and
    ``wo``'s rows inside one region, where the rules split either over
    ``model`` and ``model`` divides d_ff: a leaf placed otherwise is
    brought to that form (``Placement.reshard``).  Else both run whole:
    under sequence parallelism, the rank's rows of the stream through
    them (their gradients shares, ``whole_in_region``)."""
    wi, wo, region = p["wi"], p["wo"], None
    pl = tp.current()
    if pl is not None:
        glu = cfg.mlp_glu
        shapes = {"wi": (cfg.d_model, (2 if glu else 1) * cfg.d_ff),
                  "wo": (cfg.d_ff, cfg.d_model)}
        wi, idim = pl.param(wi, "wi", shapes["wi"], glu=glu)
        wo, odim = pl.param(wo, "wo", shapes["wo"])
        split = cfg.d_ff % pl.model == 0 and any(
            pl.splits_model(k, v) for k, v in shapes.items())
        wi = pl.reshard(wi, idim, 1 if split else None, glu)
        wo = pl.reshard(wo, odim, 0 if split else None)
        if split:
            region = pl
        elif pl.seq:
            wi, wo = pl.whole_in_region(wi), pl.whole_in_region(wo)
    if region is not None:
        x = region.enter(x)
    h = linear(x, wi, activation=cfg.mlp_activation, glu=cfg.mlp_glu,
               backend=_mm_backend(cfg))
    if region is not None:
        return row_parallel(cfg, region, h, wo)
    return linear(h, wo, backend=_mm_backend(cfg))


def stream_leaf(t):
    """A leaf applied row by row to the residual stream (a norm's scale
    or bias, a slice of learned positions): under sequence parallelism
    each rank applies it to its share of the sequence, so that its
    gradient is a share of the whole one, summed over ``model``
    (``whole_in_region``)."""
    pl = tp.current()
    return pl.whole_in_region(t) if pl is not None and pl.seq else t


# ---------------------------------------------------------------------------
# Embedding / logits.
# ---------------------------------------------------------------------------

def _vocab_placed(pl, w, name: str, shape, vocab: int):
    """(the embedding or output leaf ``w`` gathered over the data axes,
    whether it holds the rank's vocabulary range along dim ``vocab``):
    where the rules split it over ``model`` and ``model`` divides the
    vocabulary, that form (``Placement.reshard``); else whole."""
    w, dim = pl.param(w, name, shape)
    split = shape[vocab] % pl.model == 0 and pl.splits_model(name, shape)
    return pl.reshard(w, dim, vocab if split else None), split


def embed_tokens(cfg: ArchConfig, embedding, tokens):
    """Under a mesh, vocab-parallel: each rank looks up the tokens of its
    vocabulary range (zeros elsewhere) and the ranks' rows are summed
    (reduce-scattered along the sequence when the pass shards it).  An
    embedding the rules keep whole looks up the rank's share of the
    tokens under sequence parallelism."""
    pl = tp.current()
    if pl is None:
        x = embedding[tokens]
    else:
        w, split = _vocab_placed(pl, embedding, "embedding",
                                 (cfg.padded_vocab, cfg.d_model), 0)
        if not split:
            if pl.seq:
                w, tokens = pl.whole_in_region(w), pl.seq_rows(tokens)
            x = w[tokens]
        else:
            n = w.shape[0]
            local = tokens - pl.rank * n
            hit = (local >= 0) & (local < n)
            x = torch.where(hit[..., None], w[torch.where(hit, local, 0)],
                            0.0).to(w.dtype)
            x = pl.exit(x)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model),
                             dtype=torch.float32).to(x.dtype)
    return x


def output_weight(cfg: ArchConfig, params, pl=None):
    """(the (d, V) output weight, whether it holds the rank's vocabulary
    columns): the tied embedding's transpose or ``lm_head``, gathered over
    the data axes under a mesh (``_vocab_placed``)."""
    v, d = cfg.padded_vocab, cfg.d_model
    if cfg.tie_embeddings:
        w, split = params["embedding"], False
        if pl is not None:
            w, split = _vocab_placed(pl, w, "embedding", (v, d), 0)
        return w.T, split
    w, split = params["lm_head"], False
    if pl is not None:
        w, split = _vocab_placed(pl, w, "lm_head", (d, v), 1)
    return w, split


def logits_out(cfg: ArchConfig, params, x):
    """Under a mesh, column-parallel over the vocabulary (the softcap per
    element, as on one card), then gathered: every rank returns every
    column.  A whole output weight under sequence parallelism takes the
    gathered stream: every rank computes every row's logits."""
    pl = tp.current()
    w, split = output_weight(cfg, params, pl)
    if split:
        x = pl.enter(x)
    elif pl is not None:
        x = pl.gather_stream(x)
    y = linear(x, w, softcap=cfg.final_softcap, out_dtype=torch.float32,
               backend=_mm_backend(cfg))
    return pl.gather_model(y, -1) if split else y


# ---------------------------------------------------------------------------
# KV cache helpers (dense buffer, optionally quantized dtype).
# ---------------------------------------------------------------------------

def cache_update(k_cache, v_cache, k_new, v_new, pos: int, start: int = 0,
                 length: "int | None" = None):
    """Write (B, Hkv, S_new, D) at position ``pos`` along the S axis.

    Writes in place (the reference returns new arrays): a serving cache
    is updated every step, and a copy per step would double its memory.
    ``k_cache`` and ``v_cache`` may hold a share of a cache of ``length``
    positions (by default their own), positions ``[start, start + S)``:
    of the new rows, those that fall there are written.  Returns the
    same two tensors.
    """
    s_new, cap = k_new.shape[2], k_cache.shape[2]
    length = cap if length is None else length
    if not 0 <= pos <= length - s_new:
        raise ValueError(f"cache write of {s_new} at {pos} exceeds its "
                         f"length {length}")
    lo, hi = max(pos, start), min(pos + s_new, start + cap)
    if lo < hi:
        k_cache[:, :, lo - start:hi - start] = \
            k_new[:, :, lo - pos:hi - pos].to(k_cache.dtype)
        v_cache[:, :, lo - start:hi - start] = \
            v_new[:, :, lo - pos:hi - pos].to(v_cache.dtype)
    return k_cache, v_cache


# ---------------------------------------------------------------------------
# Activation remat (training).
# ---------------------------------------------------------------------------

#: the products ``remat="dots"`` keeps: K1's op, and aten's 2-D matrix
#: products, the dots with no batch dimension of the reference's
#: ``checkpoint_dots_with_no_batch_dims`` (the torch matmul route's
#: ``linear``, the MoE router, RWKV-6's LoRA second factors); batched
#: products (attention, the plain expert einsum, the WKV) are recomputed
_DOTS = (mm_ops.FUSED_MATMUL_OP, torch.ops.aten.mm.default,
         torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(_dots_policy)


def remat(cfg: ArchConfig, fn, *args):
    """``fn(*args)`` under ``cfg.remat``: the counterpart of the reference's
    ``jax.checkpoint(body, policy=remat_policy(cfg))``.

    ``"full"`` (the reference's ``nothing_saveable``) runs ``fn`` through
    ``torch.utils.checkpoint`` without reentry: the forward keeps only
    ``args``, and the backward runs ``fn`` again, kernel launches
    included.  ``"dots"`` (the reference's
    ``checkpoint_dots_with_no_batch_dims``) is the same checkpoint with
    a selective policy: it keeps every matrix product's output (``_DOTS``:
    K1's op and aten's 2-D products), so the recompute launches no K1
    forward, and recomputes the rest (norms, activations, RoPE, batched
    products).  Either applies only where autograd tracks the call, grad
    mode on and a tensor of ``args`` (trees of tensors too) requiring grad; elsewhere,
    as in serving, ``fn`` runs as it is.
    """
    if cfg.remat not in ("full", "dots", "none"):
        raise ValueError(f"unknown remat {cfg.remat!r}; use 'full', 'dots' "
                         "or 'none'")
    tracked = torch.is_grad_enabled() and any(
        torch.is_tensor(t) and t.requires_grad for t in tree.leaves(args))
    if cfg.remat == "none" or not tracked:
        return fn(*args)
    if cfg.remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=_dots_contexts)
