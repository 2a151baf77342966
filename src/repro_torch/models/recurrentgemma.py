"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks + local MQA.

Block pattern (arXiv:2402.19427): (recurrent, recurrent, local-attention)
repeating; every temporal block is followed by a GeGLU MLP block.  The
recurrent block is: two input projections (gate branch GeLU; rnn branch →
short causal conv1d → RG-LRU), merge by product, output projection.
Local attention is MQA (1 KV head) with window 2048 and RoPE.

26 layers = 8 × (rec, rec, attn) + 2 trailing recurrent blocks: a Python
loop walks the 8 triples (the reference's ``lax.scan``), each under
``cm.remat`` where autograd tracks it, then the tail.

Routes (``cfg.backend``): ``kernel`` runs the RG-LRU through the CUDA
scan (``kernels/rglru``) and prefill attention through the flash kernel;
``torch`` and ``dense`` run ``rglru_ref``, which autograd differentiates
(training).  A decode step (T = 1) takes
the plain one-token step on every route.  The serving state is updated
in place: the RNN carry and conv tail are copied into the cache, and the
window's keys and values are written into its ring.

Under a mesh this process is a rank of (``distributed.tensor_parallel``),
the recurrent block runs on the rank's share of the d_rnn channels:
``w_gate_in`` and ``w_rnn_in`` column-parallel, the conv and the RG-LRU
(K5) on its channels, ``w_rnn_out`` row-parallel.  The gates contract
over every channel, so the conv output is gathered over ``model`` and the
rank computes its columns of each gate in one product over the whole
width, as one rank does.  The leaves the rules replicate (the conv, the
gates, ``lambda_p``) are sliced to the rank's channels, their gradients
partial sums (``whole_in_region``).  The state keeps the reference's
form, whole over ``model``: a pass reads the rank's rows and channels of
it and writes its new state back gathered (``Placement.read_state`` /
``write_state``).  The local attention's ring takes the reference's
sequence form where ``model`` divides the window: a rank writes the
slots it holds and a decode step attends over them, the ranks' max, sum
and P·V merged (``common.split_decode``).  One process runs the same
path over a ring it holds whole (``CacheShard.whole``).

Under sequence parallelism (the rules map ``seq`` to ``model``) the
residual stream between blocks holds the rank's share of the sequence:
the recurrent block's entry gathers it, so that the conv, which reads
three tokens back across the shares, and K5 run on the rank's channels
over the whole sequence, and ``w_rnn_out``'s exit reduce-scatters it.
A prefill's second, stateful pass over the window's tail decides its own
sharding by its length.
"""

from __future__ import annotations

import sys

import torch

from repro_torch.core import tree
from repro_torch.core.fusion import linear
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import common as cm
from repro_torch.models.base import ArchConfig, register_family


# ---------------------------------------------------------------------------
# RG-LRU + conv recurrent block.
# ---------------------------------------------------------------------------

def _rec_init(cfg: ArchConfig, gen: torch.Generator, device=None):
    d, rn, dt = cfg.d_model, cfg.rnn, cfg.dtype
    kw = dict(device=device)
    return {
        "w_gate_in": cm.dense_init(gen, (d, rn.d_rnn), dt, **kw),
        "w_rnn_in": cm.dense_init(gen, (d, rn.d_rnn), dt, **kw),
        "conv_w": (torch.randn((rn.conv_width, rn.d_rnn), generator=gen,
                               **kw) * 0.1).to(dt),
        "conv_b": torch.zeros((rn.d_rnn,), dtype=dt, **kw),
        # RG-LRU gates (block-diagonal dense in the reference; dense here).
        "w_input_gate": cm.dense_init(gen, (rn.d_rnn, rn.d_rnn), dt, **kw),
        "b_input_gate": torch.zeros((rn.d_rnn,), dtype=dt, **kw),
        "w_rec_gate": cm.dense_init(gen, (rn.d_rnn, rn.d_rnn), dt, **kw),
        "b_rec_gate": torch.zeros((rn.d_rnn,), dtype=dt, **kw),
        "lambda_p": torch.rand((rn.d_rnn,), generator=gen, **kw) * 4.0 + 2.0,
        "w_rnn_out": cm.dense_init(gen, (rn.d_rnn, d), dt, in_axis=1, **kw),
    }


def _causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv1d.  x: (B, T, C); w: (W, C).

    ``conv_state``: (B, W-1, C) trailing inputs from the previous call
    (decode); returns (y, new_state).
    """
    width, t = w.shape[0], x.shape[1]
    if conv_state is None:
        pad = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + t] * w[i] for i in range(width)) + b
    return y.to(x.dtype), xp[:, -(width - 1):]


def _rglru_gates(cfg: ArchConfig, p, x, pl=None, span=None):
    """log_a (B, T, C) and gated input for the RG-LRU, both fp32.  On a
    rank (``span``: its channels), the gates' columns of ``x`` gathered
    over every channel."""
    names = ("w_input_gate", "b_input_gate", "w_rec_gate", "b_rec_gate",
             "lambda_p")
    w_i, b_i, w_r, b_r, lam = (p[k] for k in names)
    src = x
    if span is not None:
        src = pl.gather_model(x, -1)
        w_i, b_i, w_r, b_r, lam = (pl.whole_in_region(t)[..., span]
                                   for t in (w_i, b_i, w_r, b_r, lam))
    i_gate = torch.sigmoid(linear(src, w_i, b_i).float())
    r_gate = torch.sigmoid(linear(src, w_r, b_r).float())
    lam = lam.float()
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))  # jax's form
    log_a = -cfg.rnn.c * softplus * r_gate
    return log_a, i_gate * x.float()


def _rglru_seq(cfg: ArchConfig, log_a, gated):
    if cfg.backend == "kernel":
        from repro_torch.kernels.rglru.ops import rglru_scan
        return rglru_scan(log_a, gated.float())[0]
    from repro_torch.kernels.rglru.ref import rglru_ref
    return rglru_ref(log_a, gated)[0]


def _rglru_stateful(cfg: ArchConfig, log_a, gated, h0):
    """(h (B, T, C), h_T) from the carried state ``h0``: one plain step
    at decode, the kernel (``kernel`` route) or ``rglru_ref`` at T > 1."""
    if log_a.shape[1] == 1:
        from repro_torch.kernels.rglru.ref import rglru_decode_step
        out, new = rglru_decode_step(h0, log_a[:, 0], gated[:, 0])
        return out[:, None], new
    if cfg.backend == "kernel":
        from repro_torch.kernels.rglru.ops import rglru_scan
        return rglru_scan(log_a, gated.float(), initial_state=h0)
    from repro_torch.kernels.rglru.ref import rglru_ref
    return rglru_ref(log_a, gated, initial_state=h0)


def _rec_leaves(cfg: ArchConfig) -> dict:
    """The recurrent block's projections: {leaf: (whole shape, the dim its
    ``model`` shard lies along in the column/row form)}."""
    d, c = cfg.d_model, cfg.rnn.d_rnn
    return {"w_gate_in": ((d, c), 1), "w_rnn_in": ((d, c), 1),
            "w_rnn_out": ((c, d), 0)}


def rec_split(cfg: ArchConfig, pl) -> bool:
    """Whether the rank runs the recurrent block on its share of the
    channels: where the rules split any of its projections over
    ``model`` and ``model`` divides d_rnn (a projection placed otherwise
    is brought to the column/row form, ``Placement.reshard``); else
    every rank runs every channel on the whole leaves, and its state
    holds every channel (``_rank_states``)."""
    return (pl.model > 1 and cfg.rnn.d_rnn % pl.model == 0
            and any(pl.splits_model(k, shape)
                    for k, (shape, _) in _rec_leaves(cfg).items()))


def rec_block_apply(cfg: ArchConfig, p, x, state=None):
    """x: (B, T, d).  state: {conv: (B, W-1, C), h: (B, C)} or None: on a
    rank of a mesh, its rows and its channels of them (``rec_split``).
    Where the rules keep the block's leaves whole, under sequence
    parallelism every rank runs it over the gathered stream and keeps
    its rows."""
    w_gate, w_rnn, w_out = p["w_gate_in"], p["w_rnn_in"], p["w_rnn_out"]
    conv_w, conv_b = p["conv_w"], p["conv_b"]
    pl, span, rows = tp.current(), None, False
    if pl is not None:
        split = rec_split(cfg, pl)
        w_gate, w_rnn, w_out = (
            pl.reshard(*pl.param(p[k], k, shape), dim if split else None)
            for k, (shape, dim) in _rec_leaves(cfg).items())
        if split:
            cols = cfg.rnn.d_rnn // pl.model
            span = slice(pl.rank * cols, (pl.rank + 1) * cols)
            x = pl.enter(x)
            conv_w, conv_b = (pl.whole_in_region(t)[..., span]
                              for t in (conv_w, conv_b))
        elif pl.seq:            # each leaf's gradient a share of the rows'
            p = {k: pl.whole_in_region(v) for k, v in p.items()}
            w_gate, w_rnn, w_out = (pl.whole_in_region(t)
                                    for t in (w_gate, w_rnn, w_out))
            conv_w, conv_b = p["conv_w"], p["conv_b"]
            x, rows = pl.gather_model(x, 1), True
    gate = linear(x, w_gate, activation="gelu_tanh")
    rnn_in = linear(x, w_rnn)
    conv_state = state["conv"] if state is not None else None
    rnn_in, new_conv = _causal_conv(rnn_in, conv_w, conv_b, conv_state)
    log_a, gated = _rglru_gates(cfg, p, rnn_in, pl, span)
    if state is None:
        h = _rglru_seq(cfg, log_a, gated)
        new_state = None
    else:
        h, h_final = _rglru_stateful(cfg, log_a, gated, state["h"])
        new_state = {"conv": new_conv, "h": h_final}
    h = h.to(x.dtype) * gate
    if span is not None:
        return cm.row_parallel(cfg, pl, h, w_out), new_state
    out = linear(h, w_out)
    return (pl.seq_rows(out) if rows else out), new_state


# ---------------------------------------------------------------------------
# Full blocks: temporal (rec | attn) + MLP, Griffin residual layout.
# ---------------------------------------------------------------------------

def _block_init(cfg: ArchConfig, gen: torch.Generator, kind: str,
                device=None):
    kw = dict(dtype=cfg.dtype, device=device)
    p = {"ln_t": torch.zeros((cfg.d_model,), **kw),
         "ln_mlp": torch.zeros((cfg.d_model,), **kw)}
    if kind == "rec":
        p["temporal"] = _rec_init(cfg, gen, device)
    else:
        p["temporal"] = cm.attn_init(cfg, gen, device)
    p["mlp"] = cm.mlp_init(cfg, gen, device)
    return p


def _ring_write(k_cache, v_cache, k_new, v_new, pos: int, start: int = 0,
                length: "int | None" = None):
    """Write (B, Hkv, S_new, D) into the window ring at slot ``pos``.

    The start is clamped to [0, window - S_new], as the reference's
    ``dynamic_update_slice`` clamps it: a prompt longer than the window
    writes its last ``window`` keys from slot 0 (slot i holds position
    s - window + i), and the next decode step writes at ``pos % window``.
    The ring may be a rank's share of a window of ``length`` slots,
    slots ``[start, start + S)`` (``common.cache_update``).
    """
    window = k_cache.shape[2] if length is None else length
    at = max(0, min(pos, window - k_new.shape[2]))
    return cm.cache_update(k_cache, v_cache, k_new, v_new, at, start, window)


def _norm(cfg: ArchConfig, x, w):
    return cm.rmsnorm(x, cm.stream_leaf(w), cfg.rms_eps, unit_offset=True)


def block_apply(cfg: ArchConfig, p, x, *, kind, positions, state=None,
                cache_pos=None, shard=None):
    """``shard``: where an attention block's ring (``state``) lies in
    the whole window (``_ring_attention``)."""
    h = _norm(cfg, x, p["ln_t"])
    if kind == "rec":
        t_out, new_state = rec_block_apply(cfg, p["temporal"], h, state)
    else:
        if state is None:
            q, k, v = cm.qkv_project(cfg, p["temporal"], h, positions)
            ctx = cm.attention(cfg, q, k, v, causal=True, window=cfg.window)
        else:
            ctx = _ring_attention(cfg, p["temporal"], h, positions, state,
                                  cache_pos, shard)
        new_state = state
        t_out = cm.attn_out(cfg, p["temporal"], ctx)
    x = x + t_out
    h = _norm(cfg, x, p["ln_mlp"])
    x = x + cm.mlp_apply(cfg, p["mlp"], h)
    return x, new_state


def _ring_decode(cfg: ArchConfig, q, k_cache, v_cache, pos: int):
    """Decode attention over a ring-buffered window cache.

    Positions are physical slots; validity = all slots once pos >= window,
    else slots < pos+1.  RoPE was applied pre-cache with absolute
    positions, so scores are position-consistent regardless of slot order.
    """
    from repro_torch.kernels.attention.ref import NEG_INF
    b, h, _, d = q.shape
    hkv = k_cache.shape[1]
    qe = q.reshape(b, hkv, h // hkv, d).float()
    scores = torch.einsum("bngd,bnsd->bngs", qe,
                          k_cache.float()) * cfg.sm_scale
    slots = torch.arange(cfg.window, device=q.device)
    valid = slots <= min(pos, cfg.window - 1)
    scores = torch.where(valid, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngs,bnsd->bngd", p, v_cache.float())
    return out.reshape(b, h, 1, d).to(q.dtype)


def _ring_attention(cfg: ArchConfig, p, h, positions, state, pos: int,
                    shard: tp.CacheShard):
    """Local attention with the window ring ``state``, which holds the
    one KV head at slots ``[shard.start, shard.start + S)`` of the
    window: every slot on one process, or where ``model`` does not divide
    the window; else the rank's share.  K and V of the KV head are
    written at the slots the ring holds, from ``_ring_write``'s clamped
    start; a prefill attends with the (rank's) q heads over the prompt
    (K2), as without a ring; a decode step over the ring's valid slots,
    each rank over its own where they are shared out over ``model``
    (``common.split_decode``, every q head on each rank)."""
    pl = tp.current()
    q, k, v = cm.qkv_project(cfg, p, h, positions, every_kv=True)
    read = cm.kv_read(cfg, pl, q)
    k_c, v_c = _ring_write(state["k"], state["v"], k, v, pos % cfg.window,
                           shard.start, shard.length)
    if q.shape[2] > 1:
        return cm.attention(cfg, q, k[:, read], v[:, read], causal=True,
                            window=cfg.window)
    if not shard.split:
        k_c, v_c = cm.cache_view(pl, shard, k_c, v_c)
        return _ring_decode(cfg, q, k_c[:, read], v_c[:, read], pos)
    return cm.split_decode(cfg, pl, q, k_c, v_c, min(pos + 1, cfg.window),
                           shard.start, sm_scale=cfg.sm_scale)


# ---------------------------------------------------------------------------
# Stack: the (rec, rec, attn) triples, then the remainder.
# ---------------------------------------------------------------------------

def _pattern(cfg: ArchConfig):
    pat = cfg.rnn.block_pattern
    n_triples = cfg.n_layers // len(pat)
    rem = tuple(pat[i] for i in range(cfg.n_layers - n_triples * len(pat)))
    return pat, n_triples, rem


def init(cfg: ArchConfig, gen: torch.Generator, device=None):
    """Seeded random parameters with the reference's distributions."""
    pat, n_triples, rem = _pattern(cfg)
    params = {
        "embedding": cm.embed_init(gen, (cfg.padded_vocab, cfg.d_model),
                                   cfg.dtype, device),
        "ln_final": torch.zeros((cfg.d_model,), dtype=cfg.dtype,
                                device=device),
    }
    params["triples"] = tuple(
        cm.stack_init(lambda kind=kind: _block_init(cfg, gen, kind, device),
                      n_triples)
        for kind in pat)
    params["tail"] = tuple(_block_init(cfg, gen, kind, device)
                           for kind in rem)
    return params


def _store(state, new):
    """Copy a block's new state into its (stacked) cache slot; the ring
    was already written in place."""
    for key, value in new.items():
        if value is not state[key]:
            state[key].copy_(value)


def _apply_stack(cfg: ArchConfig, params, x, positions, states=None,
                 cache_pos=None):
    """Each (rec, rec, attn) triple under ``cm.remat``, as the reference
    remats its scan body, then the tail blocks without it.  On a rank of
    a mesh the recurrent states run as the rank's rows and channels
    (``_rank_states``) and are written back after the pass."""
    pat, n_triples, rem = _pattern(cfg)
    pl = tp.current() if states is not None else None
    work, shards = states, {}
    if states is not None:
        shards = {i: (tp.CacheShard.whole(cfg.window) if pl is None
                      else pl.cache_shard(cfg, states["triples"][i]["k"]))
                  for i, kind in enumerate(pat) if kind == "attn"}
    if pl is not None:
        work = _rank_states(cfg, pl, states)

    def run(x, blocks):
        for kind, lp, st, shard in blocks:
            x, new = block_apply(cfg, lp, x, kind=kind, positions=positions,
                                 state=st, cache_pos=cache_pos, shard=shard)
            if st is not None:
                _store(st, new)
        return x

    for j in range(n_triples):
        triple = [(kind, cm.layer(params["triples"][i], j),
                   None if states is None
                   else cm.layer(work["triples"][i], j), shards.get(i))
                  for i, kind in enumerate(pat)]
        x = cm.remat(cfg, run, x, triple)
    x = run(x, [(kind, params["tail"][i],
                 None if states is None else work["tail"][i], None)
                for i, kind in enumerate(rem)])
    if pl is not None:
        _write_states(cfg, pl, states, work)
    return x, states


#: the batch dim of a state leaf: the stacked triples' lead with layers
_ROWS = {"triples": 1, "tail": 0}


def _rank_states(cfg: ArchConfig, pl, states):
    """``states`` with each recurrent leaf as the rank's copy of its rows
    and the channels its block runs on (``Placement.read_state``,
    ``rec_split``); the rings as they are."""
    split = rec_split(cfg, pl)
    return {group: tuple({k: pl.read_state(cfg, x, rows, -1, split)
                          for k, x in st.items()} if "h" in st else st
                         for st in states[group])
            for group, rows in _ROWS.items()}


def _write_states(cfg: ArchConfig, pl, states, work) -> None:
    """Each recurrent leaf of ``work`` back into ``states``' cache leaf
    (``Placement.write_state``)."""
    split = rec_split(cfg, pl)
    for group, rows in _ROWS.items():
        for st, new in zip(states[group], work[group]):
            if "h" in st:
                for k in st:
                    pl.write_state(cfg, st[k], new[k], rows, -1, split)


def forward(cfg: ArchConfig, params, batch, return_hidden: bool = False):
    """Full-sequence forward (training / evaluation); ``return_hidden``
    stops at the final norm, for the chunked loss."""
    s = batch["tokens"].shape[1]
    tp.begin_pass(s)
    x = cm.embed_tokens(cfg, params["embedding"], batch["tokens"])
    positions = torch.arange(s, device=x.device)
    x, _ = _apply_stack(cfg, params, x, positions)
    x = _norm(cfg, x, params["ln_final"])
    if return_hidden:
        return x
    return cm.logits_out(cfg, params, x)


def _state_for(cfg: ArchConfig, kind, batch_size, dtype, device):
    rn = cfg.rnn
    if kind == "rec":
        return {"conv": torch.zeros((batch_size, rn.conv_width - 1,
                                     rn.d_rnn), dtype=dtype, device=device),
                "h": torch.zeros((batch_size, rn.d_rnn),
                                 dtype=torch.float32, device=device)}
    s = (batch_size, cfg.n_kv_heads, cfg.window, cfg.head_dim)
    return {"k": torch.zeros(s, dtype=cfg.kv_cache_dtype, device=device),
            "v": torch.zeros(s, dtype=cfg.kv_cache_dtype, device=device)}


def init_cache(cfg: ArchConfig, batch_size: int, max_len: int, dtype=None,
               device=None):
    del max_len                 # bounded: window cache + O(1) RNN state
    dtype = dtype or cfg.dtype
    pat, n_triples, rem = _pattern(cfg)

    def stacked(kind):
        one = _state_for(cfg, kind, batch_size, dtype, device)
        return tree.tree_map(lambda x: x.new_zeros((n_triples, *x.shape)),
                             one)

    return {"triples": tuple(stacked(k) for k in pat),
            "tail": tuple(_state_for(cfg, k, batch_size, dtype, device)
                          for k in rem)}


def prefill(cfg: ArchConfig, params, batch, cache):
    """A sequence pass for the last position's logits, then a stateful pass
    over the prompt's last ``window`` tokens that fills the cache, as the
    reference does.  Each pass decides its own sharding of the
    sequence (``tensor_parallel.begin_pass``)."""
    tokens = batch["tokens"]
    pl = tp.begin_pass(tokens.shape[1])
    x = cm.embed_tokens(cfg, params["embedding"], tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    x_out, _ = _apply_stack(cfg, params, x, positions)
    if pl is not None:                      # the last token's rank's share
        x_out = pl.whole_sequence(x_out)
    x_last = _norm(cfg, x_out[:, -1], params["ln_final"])
    logits = cm.logits_out(cfg, params, x_last)
    return logits, _prefill_states(cfg, params, batch, cache)


def _prefill_states(cfg: ArchConfig, params, batch, cache):
    """Recompute bounded states for the prompt tail (window + RNN carry):
    a second pass over the final ``min(window, s)`` tokens."""
    tokens = batch["tokens"]
    s = tokens.shape[1]
    tail = min(cfg.window, s)
    tp.begin_pass(tail)
    x = cm.embed_tokens(cfg, params["embedding"], tokens[:, -tail:])
    positions = torch.arange(s - tail, s, device=x.device)
    _, new_states = _apply_stack(cfg, params, x, positions, states=cache,
                                 cache_pos=(s - tail) % cfg.window)
    return new_states


def decode_step(cfg: ArchConfig, params, tokens, cache, pos: int):
    """tokens: (B, 1); pos: current length (int).  One decode step."""
    tp.begin_pass(tokens.shape[1])
    x = cm.embed_tokens(cfg, params["embedding"], tokens)
    positions = torch.full((tokens.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    x, cache = _apply_stack(cfg, params, x, positions, states=cache,
                            cache_pos=pos)
    x = _norm(cfg, x, params["ln_final"])
    return cm.logits_out(cfg, params, x[:, -1]), cache


register_family("griffin")(sys.modules[__name__])
