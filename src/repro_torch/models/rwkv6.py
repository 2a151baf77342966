"""RWKV-6 (Finch) — attention-free SSM family.

Faithful block structure (arXiv:2404.05892):
  * Time-mix: token-shift DDLerp (shared low-rank W1 + per-target W2)
    produces r/k/v/g/w mixes; data-dependent decay via a decay LoRA;
    the WKV recurrence (kernels/rwkv6); per-head GroupNorm; SiLU gate;
    output projection.
  * Channel-mix: token-shift lerp, squared-ReLU FFN with a sigmoid
    receptance gate.

Every projection goes through ``cute_matmul``; the DDLerp and decay-LoRA
second factors are plain products, as in the reference.  The WKV routes
(``cfg.backend``): ``kernel`` is the CUDA chunked kernel (chunk 32 in
``forward``, the reference's ``pallas``; chunk 64 with the carried state
at prefill), ``torch`` the same chunked arithmetic in tensor ops
(``rwkv6_chunked``, the reference's ``xla`` and its prefill path), and
``dense`` the per-token oracle in ``forward``; autograd differentiates
the ``torch`` and ``dense`` routes (training).  A decode step (T = 1)
takes the oracle's single step on every route.  Layers are stacked on a
leading axis and walked by a Python loop; the serving state is updated
in place.

Under a mesh this process is a rank of (``distributed.tensor_parallel``),
the time mix runs on the rank's heads: ``w_r``, ``w_k``, ``w_v`` and
``w_g`` column-parallel over whole heads, the WKV (K6) on those heads
with the rank's share of the state, which the reference's cache holds in
its KV-head form, and ``w_o`` row-parallel.  The DDLerp runs on the whole
stream on every rank; the leaves the rules replicate and the rank reads a
slice of (``w0``, ``u``, ``ln_x``, ``ln_x_b``, ``decay_w2``'s columns)
have partial gradients (``whole_in_region``).  The channel mix runs
``w_cm_k`` column- and ``w_cm_v`` row-parallel, and the rank's columns of
the receptance are gathered before they gate the whole output.

Where the model axis does not divide the heads (reduced RWKV-6's 4 heads
on 8 ranks), a rank's columns of ``w_r``, ``w_k``, ``w_v`` and ``w_g``
are a part of a head, and the reference's cache splits the WKV state
along its key channels over ``model`` (whole, where those do not divide
either).  Each rank gathers r, k and v into whole heads, computes the
decay of every head from the replicated LoRA leaves, gathers the state
along its key channels, and runs the whole WKV (K6) from it: every rank
computes every head.  It group-norms whole heads, keeps its key
channels' rows of the new state and its columns of the output, gates
them with its columns of g and exits through ``w_o``'s rows.  The
gathers' backward reduce-scatters: each rank's gradient of the whole
heads is a partial, from its own output columns.  Full RWKV-6-7B's 64
heads take this form only on a model axis of 128.

Under sequence parallelism (the rules map ``seq`` to ``model``) the
residual stream between blocks holds the rank's share of the sequence.
Each mix's token shift reads the previous token across the shares, so
the block's normed input is gathered once (``Placement.gather_stream``):
the shift and the DDLerp run on the whole stream on every rank, the
projections enter from it (``whole_in_region``), K6 runs on the rank's
heads over the whole sequence, and ``w_o`` and ``w_cm_v`` exit by
reduce-scatter; the receptance's columns are gathered and the rank keeps
its rows.  Where the rules keep the projections whole, every rank runs
the mix over the gathered stream and keeps its rows.
"""

from __future__ import annotations

import functools
import sys

import torch

from repro_torch import NotPorted
from repro_torch.core.fusion import linear
from repro_torch.distributed import collectives
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels.rwkv6.ref import rwkv6_ref
from repro_torch.kernels.rwkv6.rwkv6 import rwkv6_chunked
from repro_torch.models import common as cm
from repro_torch.models.base import ArchConfig, register_family

_N_MIX = 5     # r, k, v, g, w


def _wkv(cfg: ArchConfig, r, k, v, lw, u):
    if cfg.backend == "kernel":
        from repro_torch.kernels.rwkv6.ops import rwkv6_scan
        return rwkv6_scan(r, k, v, lw, u, chunk=32)[0]
    if cfg.backend == "dense":
        return rwkv6_ref(r, k, v, lw, u)[0]
    if cfg.backend != "torch":
        raise ValueError(f"unknown WKV backend {cfg.backend!r}; use "
                         "'kernel', 'torch' or 'dense'")
    return rwkv6_chunked(r, k, v, lw, u, chunk=64)[0]


def _wkv_stateful(cfg: ArchConfig, r, k, v, lw, u, state):
    """(o, new_state) from the carried state: the single-step oracle at
    decode; the chunked form (chunk 64) at prefill, through the kernel on
    the ``kernel`` route."""
    if r.shape[2] == 1:
        return rwkv6_ref(r, k, v, lw, u, initial_state=state)
    if cfg.backend == "kernel":
        from repro_torch.kernels.rwkv6.ops import rwkv6_scan
        return rwkv6_scan(r, k, v, lw, u, chunk=64, initial_state=state)
    return rwkv6_chunked(r, k, v, lw, u, chunk=64, initial_state=state)


# ---------------------------------------------------------------------------
# Parameters.
# ---------------------------------------------------------------------------

def _layer_init(cfg: ArchConfig, gen: torch.Generator, device=None):
    d, rw, dt = cfg.d_model, cfg.rwkv, cfg.dtype

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=device)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def dense(*shape, in_axis=0):
        return cm.dense_init(gen, shape, dt, in_axis=in_axis, device=device)

    def ones():
        return torch.ones((d,), dtype=dt, device=device)

    def zeros():
        return torch.zeros((d,), dtype=dt, device=device)

    return {
        "ln1": ones(), "ln1_b": zeros(), "ln2": ones(), "ln2_b": zeros(),
        # DDLerp token-shift mixes.
        "mu_x": (uniform(d) * 0.5).to(dt),
        "mu_rkvgw": (uniform(_N_MIX, d) * 0.5).to(dt),
        "mix_w1": dense(d, _N_MIX * rw.lora_mix),
        "mix_w2": (normal(_N_MIX, rw.lora_mix, d) * 0.01).to(dt),
        # Time-mix projections.
        "w_r": dense(d, d), "w_k": dense(d, d), "w_v": dense(d, d),
        "w_g": dense(d, d), "w_o": dense(d, d),
        # Data-dependent decay LoRA + per-channel bases.
        "w0": uniform(d) * 2.0 - 2.0,
        "decay_w1": dense(d, rw.lora_decay),
        "decay_w2": (normal(rw.lora_decay, d) * 0.01).to(dt),
        "u": normal(d // rw.head_size, rw.head_size) * 0.3,
        "ln_x": ones(), "ln_x_b": zeros(),
        # Channel mix.
        "mu_cm_k": (uniform(d) * 0.5).to(dt),
        "mu_cm_r": (uniform(d) * 0.5).to(dt),
        "w_cm_k": dense(d, cfg.d_ff),
        "w_cm_v": dense(cfg.d_ff, d, in_axis=1),
        "w_cm_r": dense(d, d),
    }


def init(cfg: ArchConfig, gen: torch.Generator, device=None):
    """Seeded random parameters with the reference's distributions."""
    v, d = cfg.padded_vocab, cfg.d_model
    kw = dict(dtype=cfg.dtype, device=device)
    return {
        "embedding": cm.embed_init(gen, (v, d), cfg.dtype, device),
        "lm_head": cm.dense_init(gen, (d, v), cfg.dtype, device=device),
        "ln_in": torch.ones((d,), **kw), "ln_in_b": torch.zeros((d,), **kw),
        "ln_final": torch.ones((d,), **kw),
        "ln_final_b": torch.zeros((d,), **kw),
        "layers": cm.stack_init(lambda: _layer_init(cfg, gen, device),
                                cfg.n_layers),
    }


# ---------------------------------------------------------------------------
# Block application.
# ---------------------------------------------------------------------------

def _shift(x, last=None):
    """Token shift: x_{t-1} (zeros or carried state at t=0)."""
    pad = torch.zeros_like(x[:, :1]) if last is None else last[:, None]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _placed(cfg: ArchConfig, pl, p, spec):
    """The rank's shards of the projections ``spec`` names ({leaf: whole
    shape}) and whether they are split over ``model``: all of them in
    the reference's column/row form, or none."""
    got = {k: pl.param(p[k], k, shape) for k, shape in spec.items()}
    dims = [dim for _, dim in got.values()]
    if any(dim is not None for dim in dims) and None in dims:
        raise NotPorted(f"{cfg.name}: {dict(zip(spec, dims))} over model "
                        "(ROADMAP item 7c)")
    return {k: w for k, (w, _) in got.items()}, dims[0] is not None


def _whole(pl, p, w, x):
    """A mix whose projections the rules keep whole, under sequence
    parallelism: (the leaves and ``w``, their gradients shares of the
    rows', the stream gathered); the caller keeps its rows."""
    return ({k: pl.whole_in_region(v) for k, v in p.items()},
            {k: pl.whole_in_region(v) for k, v in w.items()},
            pl.gather_model(x, 1))


def time_mix(cfg: ArchConfig, p, x, shift_state=None, wkv_state=None):
    """x: (B, T, d) -> (out, the whole sequence's x[:, -1], new WKV state).

    Without ``wkv_state`` the WKV runs as a sequence from a zero state
    (``forward``) and the new state is None; with it, statefully
    (serving).  On a rank of a mesh, the rank's heads, and
    ``wkv_state`` its heads' share; where ``model`` does not divide the
    heads, every head, from the state's share of the key channels (or
    the whole state), and the new state is that share; under sequence
    parallelism ``x`` and the output are the rank's share of the
    sequence.
    """
    d = x.shape[-1]
    rw = cfg.rwkv
    h = d // rw.head_size
    names = ("w_r", "w_k", "w_v", "w_g", "w_o")
    w = {k: p[k] for k in names}
    pl, split, rows, every = tp.current(), False, False, False
    if pl is not None:
        w, split = _placed(cfg, pl, p, dict.fromkeys(names, (d, d)))
        if split:
            x = pl.gather_stream(x)
        elif pl.seq:
            p, w, x = _whole(pl, p, w, x)
            rows = True
    b, t, _ = x.shape
    side = {k: p[k] for k in ("decay_w2", "w0", "u", "ln_x", "ln_x_b")}
    if split:
        every = h % pl.model != 0
        n = d // pl.model
        cols = slice(pl.rank * n, (pl.rank + 1) * n)
        side = {k: pl.whole_in_region(v) for k, v in side.items()}
        if not every:
            h //= pl.model
            side = {k: v[pl.rank * h:(pl.rank + 1) * h] if k == "u"
                    else v[..., cols] for k, v in side.items()}
    xx = _shift(x, shift_state) - x
    xxx = x + xx * p["mu_x"]
    mix = torch.tanh(linear(xxx, p["mix_w1"]))            # (B, T, 5*r)
    mix = mix.reshape(b, t, _N_MIX, rw.lora_mix)
    dyn = torch.einsum("btnr,nrd->btnd", mix, p["mix_w2"])
    mixed = x[:, :, None, :] + xx[:, :, None, :] * (
        p["mu_rkvgw"][None, None] + dyn)                  # (B, T, 5, d)
    x_r, x_k, x_v, x_g, x_w = mixed.unbind(2)
    lora = torch.tanh(linear(x_w, p["decay_w1"]))
    if split:
        x_r, x_k, x_v, x_g, lora = (pl.whole_in_region(z) for z in (
            x_r, x_k, x_v, x_g, lora))

    r = linear(x_r, w["w_r"])
    k = linear(x_k, w["w_k"])
    v = linear(x_v, w["w_v"])
    g = linear(x_g, w["w_g"], activation="silu")
    w_dyn = lora @ side["decay_w2"]
    lw = -torch.exp(torch.clamp(side["w0"][None, None].float()
                                + w_dyn.float(), -8.0, 6.0))
    if every:                    # whole heads from every rank's columns
        r, k, v = (pl.gather_model(z, -1) for z in (r, k, v))
        keys = None if wkv_state is None else wkv_state.shape[2]
        if keys is not None and keys != rw.head_size:
            wkv_state = collectives.all_gather(wkv_state, pl.group("model"),
                                               2)

    def heads(z):
        return z.reshape(b, t, h, rw.head_size).transpose(1, 2)

    args = (heads(r), heads(k), heads(v), heads(lw), side["u"])
    if wkv_state is None:
        o, wkv_new = _wkv(cfg, *args), None
    else:
        o, wkv_new = _wkv_stateful(cfg, *args, wkv_state)
    o = o.transpose(1, 2).reshape(b, t, h * rw.head_size)
    o = cm.groupnorm_heads(o, side["ln_x"], side["ln_x_b"], h)
    if every:                    # the rank's key channels and columns
        if wkv_new is not None and keys != rw.head_size:
            wkv_new = wkv_new.narrow(2, pl.rank * keys, keys)
        o = o[..., cols]
    if split:
        return cm.row_parallel(cfg, pl, o * g, w["w_o"]), x[:, -1], wkv_new
    out = linear(o * g, w["w_o"])
    return (pl.seq_rows(out) if rows else out), x[:, -1], wkv_new


def channel_mix(cfg: ArchConfig, p, x, shift_state=None):
    """On a rank of a mesh: ``w_cm_k`` column- and ``w_cm_v`` row-parallel;
    the receptance's columns (``w_cm_r``'s) gathered to gate the whole
    output, as one rank gates it (under sequence parallelism, the rank's
    rows of it)."""
    d, ff = cfg.d_model, cfg.d_ff
    w = {k: p[k] for k in ("w_cm_k", "w_cm_v", "w_cm_r")}
    pl, split, rows = tp.current(), False, False
    if pl is not None:
        w, split = _placed(cfg, pl, p, {"w_cm_k": (d, ff), "w_cm_v": (ff, d),
                                        "w_cm_r": (d, d)})
        if split:
            x = pl.gather_stream(x)
        elif pl.seq:
            p, w, x = _whole(pl, p, w, x)
            rows = True
    xx = _shift(x, shift_state) - x
    x_k = x + xx * p["mu_cm_k"]
    x_r = x + xx * p["mu_cm_r"]
    if not split:
        k = linear(x_k, w["w_cm_k"], activation="relu2")
        kv = linear(k, w["w_cm_v"])
        out = torch.sigmoid(linear(x_r, w["w_cm_r"]).float()
                            ).to(x.dtype) * kv
        return (pl.seq_rows(out) if rows else out), x[:, -1]
    k = linear(pl.whole_in_region(x_k), w["w_cm_k"], activation="relu2")
    kv = cm.row_parallel(cfg, pl, k, w["w_cm_v"])
    r = torch.sigmoid(linear(pl.whole_in_region(x_r), w["w_cm_r"]).float()
                      ).to(x.dtype)
    if pl.seq:              # every rank's columns, the rank's rows
        return pl.seq_rows(pl.gather_model(r, -1)) * kv, x[:, -1]
    return pl.gather_whole(r, -1) * kv, x[:, -1]


def _ln(x, w, b):
    return cm.layernorm(x, cm.stream_leaf(w), cm.stream_leaf(b))


def block_apply(cfg: ArchConfig, p, x):
    h = _ln(x, p["ln1"], p["ln1_b"])
    x = x + time_mix(cfg, p, h)[0]
    h = _ln(x, p["ln2"], p["ln2_b"])
    return x + channel_mix(cfg, p, h)[0]


def forward(cfg: ArchConfig, params, batch, return_hidden: bool = False):
    """Full-sequence forward (training / evaluation), each layer under
    ``cm.remat`` as the reference remats its scan body; ``return_hidden``
    stops at the final norm, for the chunked loss."""
    tp.begin_pass(batch["tokens"].shape[1])
    x = cm.embed_tokens(cfg, params["embedding"], batch["tokens"])
    x = _ln(x, params["ln_in"], params["ln_in_b"])
    for j in range(cfg.n_layers):
        x = cm.remat(cfg, functools.partial(block_apply, cfg),
                     cm.layer(params["layers"], j), x)
    x = _ln(x, params["ln_final"], params["ln_final_b"])
    if return_hidden:
        return x
    return cm.logits_out(cfg, params, x)


# ---------------------------------------------------------------------------
# Serving: state = per-layer (tm_shift, cm_shift, wkv_state).  On a rank
# of a mesh the cache is its shard in the reference's form: the shifts
# whole over ``model`` (every rank writes the same rows), the WKV state
# its heads; both at the rank's batch rows.
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch_size: int, max_len: int, dtype=None,
               device=None):
    del max_len                                   # state is O(1) in context
    d, rw = cfg.d_model, cfg.rwkv
    h = d // rw.head_size
    dt = dtype or cfg.dtype
    n = cfg.n_layers
    return {
        "tm_shift": torch.zeros((n, batch_size, d), dtype=dt, device=device),
        "cm_shift": torch.zeros((n, batch_size, d), dtype=dt, device=device),
        "wkv": torch.zeros((n, batch_size, h, rw.head_size, rw.head_size),
                           dtype=torch.float32, device=device),
    }


def _stateful_block(cfg: ArchConfig, lp, x, tm_s, cm_s, wkv_s):
    """One block with explicit state -> (x, tm_shift, cm_shift, wkv)."""
    hh = _ln(x, lp["ln1"], lp["ln1_b"])
    tm, tm_new, wkv_new = time_mix(cfg, lp, hh, tm_s, wkv_s)
    x = x + tm
    hh = _ln(x, lp["ln2"], lp["ln2_b"])
    cmix, cm_new = channel_mix(cfg, lp, hh, cm_s)
    return x + cmix, tm_new, cm_new, wkv_new


def _run_stateful(cfg: ArchConfig, params, tokens, cache):
    pl = tp.begin_pass(tokens.shape[1])
    x = cm.embed_tokens(cfg, params["embedding"], tokens)
    x = _ln(x, params["ln_in"], params["ln_in_b"])
    for j in range(cfg.n_layers):
        x, *new = _stateful_block(cfg, cm.layer(params["layers"], j), x,
                                  cache["tm_shift"][j], cache["cm_shift"][j],
                                  cache["wkv"][j])
        for key, value in zip(("tm_shift", "cm_shift", "wkv"), new):
            cache[key][j].copy_(value)
    if pl is not None:                      # the last token's rank's share
        x = pl.whole_sequence(x)
    x = _ln(x[:, -1], params["ln_final"], params["ln_final_b"])
    return cm.logits_out(cfg, params, x), cache


def prefill(cfg: ArchConfig, params, batch, cache):
    return _run_stateful(cfg, params, batch["tokens"], cache)


def decode_step(cfg: ArchConfig, params, tokens, cache, pos: int):
    del pos                                        # state carries position
    return _run_stateful(cfg, params, tokens, cache)


register_family("rwkv6")(sys.modules[__name__])
