"""Whisper-tiny encoder-decoder (audio) — backbone only, conv stub.

The conv frontend is a STUB, as in the reference: the caller supplies
precomputed frame embeddings (B, n_audio_ctx, d) in place of mel →
conv1d×2 → GELU.  The backbone is faithful Whisper: pre-LN transformer,
learned positional embeddings, bidirectional encoder, decoder with
causal self-attention and cross-attention, tied output embedding.

Serving: prefill runs the encoder once, and each decoder layer writes
its cross-attention K/V into the cache as it runs; decode appends to the
causal self-attention cache (``decode_attention``, plain ops) and
attends to the cached cross K/V through ``cm.attention`` — K2 on the
kernel route, one query row against ``n_audio_ctx`` keys.

Layer parameters are stacked on a leading layer axis (``enc_layers``,
``dec_layers``), as in the reference, and a Python loop walks the stack
where the reference runs ``lax.scan`` / ``vmap``; each encoder and
decoder layer runs under ``cm.remat`` (where autograd tracks it, as in
training), as the reference remats each scan body.  The decoder's
cross-attention projections call ``linear`` without a route, as the
reference does, so they resolve it through the tuned dispatch by shape
(``common._route``).

Under a mesh this process is a rank of (``distributed.tensor_parallel``),
every attention (the encoder's, the decoder's self- and
cross-attention) runs on the rank's heads through ``common``'s placed
projections, every head on each rank where the heads do not divide
``model`` (whose q columns are gathered), and the GELU MLP column- then
row-parallel.  Each cache leaf takes the reference's form
(``sharding.shard_cache``): the rank's KV heads, or every head at its
share of the positions, or at all of them.  A prefill projects the cross
K and V from the whole encoder output, attends with them (K2) as one
rank does and writes the rank's share into the cache; a decode step
attends over a cross cache split along its positions with the ranks'
max, sum and P·V merged (``common.split_decode``).  One process runs the
same cross-attention over a cache it holds whole (``CacheShard.whole``).

Under sequence parallelism (the rules map ``seq`` to ``model``) the
encoder's frames and the decoder's tokens are two streams of one pass,
each held between blocks as the rank's share of its sequence where
``model`` divides its length, and whole otherwise
(``Placement.shards``): the encoder runs under its own decision
(``tensor_parallel.holding``, remat's recompute too), each rank adds the
learned positions of its rows, and its output is gathered once, whole on
every rank, for every layer's cross-attention K and V.
"""

from __future__ import annotations

import sys

import torch

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import common as cm
from repro_torch.models.base import ArchConfig, register_family


def _attn_block_init(cfg: ArchConfig, gen: torch.Generator, cross: bool,
                     device=None):
    kw = dict(dtype=cfg.dtype, device=device)
    d = cfg.d_model
    p = {
        "attn": cm.attn_init(cfg, gen, device),
        "ln": torch.ones((d,), **kw),
        "ln_b": torch.zeros((d,), **kw),
    }
    if cross:
        p["cross"] = cm.attn_init(cfg, gen, device)
        p["ln_cross"] = torch.ones((d,), **kw)
        p["ln_cross_b"] = torch.zeros((d,), **kw)
    p["mlp"] = cm.mlp_init(cfg, gen, device)
    p["ln_mlp"] = torch.ones((d,), **kw)
    p["ln_mlp_b"] = torch.zeros((d,), **kw)
    return p


def init(cfg: ArchConfig, gen: torch.Generator, device=None):
    """Seeded random parameters with the reference's distributions."""
    ed, d = cfg.encdec, cfg.d_model
    kw = dict(dtype=cfg.dtype, device=device)
    return {
        "embedding": cm.embed_init(gen, (cfg.padded_vocab, d), cfg.dtype,
                                   device),
        "pos_dec": cm.embed_init(gen, (ed.max_positions, d), cfg.dtype,
                                 device),
        "pos_enc": cm.embed_init(gen, (ed.n_audio_ctx, d), cfg.dtype,
                                 device),
        "enc_layers": cm.stack_init(
            lambda: _attn_block_init(cfg, gen, False, device),
            ed.n_encoder_layers),
        "dec_layers": cm.stack_init(
            lambda: _attn_block_init(cfg, gen, True, device), cfg.n_layers),
        "ln_enc_final": torch.ones((d,), **kw),
        "ln_enc_final_b": torch.zeros((d,), **kw),
        "ln_final": torch.ones((d,), **kw),
        "ln_final_b": torch.zeros((d,), **kw),
    }


def _ln(x, w, b):
    return cm.layernorm(x, cm.stream_leaf(w), cm.stream_leaf(b))


def _positions(pl, table, start: int, n: int):
    """Rows ``[start, start + n)`` of a learned position table, the
    rank's share of them where its stream holds shares."""
    pos = cm.stream_leaf(table[start:start + n])
    return pos if pl is None else pl.seq_rows(pos, 0)


def encode(cfg: ArchConfig, params, audio_embeds):
    """audio_embeds: (B, Ta, d) — the stub conv output.  Under a mesh,
    whole on every rank; the frames a stream of their own under
    sequence parallelism."""
    pl = tp.current()
    seq = pl is not None and pl.shards(audio_embeds.shape[1])

    def body(x, lp):
        with tp.holding(seq):
            h = _ln(x, lp["ln"], lp["ln_b"])
            q, k, v = cm.qkv_project(cfg, lp["attn"], h, None)
            ctx = cm.attention(cfg, q, k, v, causal=False)
            x = x + cm.attn_out(cfg, lp["attn"], ctx)
            h = _ln(x, lp["ln_mlp"], lp["ln_mlp_b"])
            return x + cm.mlp_apply(cfg, lp["mlp"], h)

    with tp.holding(seq):
        x = audio_embeds.to(cfg.dtype)
        if pl is not None:
            x = pl.seq_rows(x)
        x = x + _positions(pl, params["pos_enc"], 0, audio_embeds.shape[1])
        for j in range(cfg.encdec.n_encoder_layers):
            x = cm.remat(cfg, body, x, cm.layer(params["enc_layers"], j))
        x = _ln(x, params["ln_enc_final"], params["ln_enc_final_b"])
        return x if pl is None else pl.gather_stream(x)


def _dec_block(cfg: ArchConfig, lp, x, enc_out=None, cross_kv=None,
               self_kv=None, cache_pos=None, shards=(None, None)):
    """x: (B, S, d) -> (B, S, d).  ``self_kv`` (k, v) is written in place
    at ``cache_pos``; ``cross_kv`` is the cached cross K/V, which a
    prefill, passing ``enc_out`` too, writes (``_cross_attention``).
    ``shards`` says where the self and cross caches lie in the whole
    (the self cache's ``None`` off a mesh)."""
    h = _ln(x, lp["ln"], lp["ln_b"])
    ctx = cm.self_attention(cfg, lp["attn"], h, None, window=0,
                            kv_cache=self_kv, cache_pos=cache_pos,
                            shard=shards[0])
    x = x + cm.attn_out(cfg, lp["attn"], ctx)

    h = _ln(x, lp["ln_cross"], lp["ln_cross_b"])
    ctx = _cross_attention(cfg, lp["cross"], h, enc_out, cross_kv,
                           shards[1])
    x = x + cm.attn_out(cfg, lp["cross"], ctx)

    h = _ln(x, lp["ln_mlp"], lp["ln_mlp_b"])
    return x + cm.mlp_apply(cfg, lp["mlp"], h)


def _decode_stack(cfg: ArchConfig, params, x, enc_out=None, caches=None,
                  cache_pos=None):
    """Walk the decoder layers; with ``caches`` each layer writes its
    self-attention K/V in place and reads its cached cross K/V, which a
    prefill (passing ``enc_out`` too) writes first.  Each layer holds
    the decoder stream's sharding (``tensor_parallel.holding``), so that
    remat's recompute, after the encoder's, holds it too."""
    pl = tp.current()
    seq = tp.seq_sharded()
    if caches is None:
        shards = (None, None)
    elif pl is None:
        shards = (None, tp.CacheShard.whole(caches["cross"][0].shape[3]))
    else:
        shards = tuple(pl.cache_shard(cfg, caches[k][0])
                       for k in ("self", "cross"))

    def body(x, lp, enc_out, cross_kv, self_kv):
        with tp.holding(seq):
            return _dec_block(cfg, lp, x, enc_out=enc_out,
                              cross_kv=cross_kv, self_kv=self_kv,
                              cache_pos=cache_pos, shards=shards)

    for j in range(cfg.n_layers):
        lp = cm.layer(params["dec_layers"], j)
        if caches is None:
            x = cm.remat(cfg, body, x, lp, enc_out, None, None)
        else:
            (ks, vs), (kc, vc) = caches["self"], caches["cross"]
            x = cm.remat(cfg, body, x, lp, enc_out, (kc[j], vc[j]),
                         (ks[j], vs[j]))
    return x, caches


def _cross_attention(cfg: ArchConfig, p, h, enc_out, cross_kv, shard):
    """Cross-attention's context, the rank's heads under a mesh.  With
    ``enc_out`` (training, or a prefill) the (rank's) q heads and the KV
    heads they read are projected (every KV head where the cache holds
    every one), a prefill writes its share of them into ``cross_kv``
    (cast to the cache's dtype, so that it attends over what a decode
    step reads), and K2 attends over every position.  A decode step
    projects q alone and attends over the cache: every q head over the
    rank's positions, merged over ``model``, where ``shard.split``."""
    pl = tp.current()
    every = shard is not None and shard.every_head
    if enc_out is not None:
        q, k, v = cm.qkv_project(cfg, p, h, None, every_kv=every,
                                 kv_x=enc_out)
        if cross_kv is not None:
            k, v = (t.to(cross_kv[0].dtype) for t in (k, v))
            held = None if pl is None or every else cm.held_heads(
                cfg, pl, shard, q, cross_kv)
            if held is None:
                cm.cache_update(*cross_kv, k, v, 0, shard.start,
                                shard.length)
            else:
                cm.write_heads(pl, cross_kv, k, v, held, 0, shard.start,
                               shard.length)
        read = cm.kv_read(cfg, pl, q) if every else slice(None)
        return cm.attention(cfg, q, k[:, read], v[:, read], causal=False)
    q = cm.cross_q_project(cfg, p, h)
    kc, vc = cross_kv
    if shard.split:
        return cm.split_decode(cfg, pl, q, kc, vc, shard.length,
                               shard.start, sm_scale=cfg.sm_scale)
    read = cm.kv_read(cfg, pl, q) if every else slice(None)
    held = None if pl is None or every else cm.held_heads(cfg, pl, shard, q,
                                                          cross_kv)
    if held is not None:          # the KV heads it reads, from every rank
        kc, vc = cm.read_heads(pl, shard, cross_kv, held)
    kc, vc = cm.cache_view(pl, shard, kc, vc)
    return cm.attention(cfg, q, kc[:, read], vc[:, read], causal=False)


def _final(cfg: ArchConfig, params, x):
    return _ln(x, params["ln_final"], params["ln_final_b"])


def _decoder_input(cfg: ArchConfig, params, tokens, pl, start: int = 0):
    """The embedded tokens plus their learned positions from ``start``
    (the rank's share of the rows under sequence parallelism)."""
    x = cm.embed_tokens(cfg, params["embedding"], tokens)
    return x + _positions(pl, params["pos_dec"], start, tokens.shape[1])


def forward(cfg: ArchConfig, params, batch, return_hidden: bool = False):
    """batch: tokens (B, S) + audio_embeds (B, Ta, d)."""
    pl = tp.begin_pass(batch["tokens"].shape[1])
    enc_out = encode(cfg, params, batch["audio_embeds"])
    x = _decoder_input(cfg, params, batch["tokens"], pl)
    x, _ = _decode_stack(cfg, params, x, enc_out=enc_out)
    x = _final(cfg, params, x)
    if return_hidden:
        return x
    return cm.logits_out(cfg, params, x)


def init_cache(cfg: ArchConfig, batch_size: int, max_len: int, dtype=None,
               device=None):
    dtype = dtype or cfg.kv_cache_dtype
    n, ed = cfg.n_layers, cfg.encdec
    self_shape = (n, batch_size, cfg.n_kv_heads, max_len, cfg.head_dim)
    cross_shape = (n, batch_size, cfg.n_kv_heads, ed.n_audio_ctx,
                   cfg.head_dim)
    kw = dict(dtype=dtype, device=device)
    return {"self": (torch.zeros(self_shape, **kw),
                     torch.zeros(self_shape, **kw)),
            "cross": (torch.zeros(cross_shape, **kw),
                      torch.zeros(cross_shape, **kw))}


def prefill(cfg: ArchConfig, params, batch, cache):
    """Encode the audio, run the decoder over the prompt, each layer
    writing its cross K/V (on a rank of a mesh, its share) and its self
    K/V into the cache; returns last-position logits and the cache
    (written in place)."""
    pl = tp.begin_pass(batch["tokens"].shape[1])
    enc_out = encode(cfg, params, batch["audio_embeds"])
    x = _decoder_input(cfg, params, batch["tokens"], pl)
    x, cache = _decode_stack(cfg, params, x, enc_out=enc_out, caches=cache,
                             cache_pos=0)
    if pl is not None:                      # the last token's rank's share
        x = pl.whole_sequence(x)
    x = _final(cfg, params, x[:, -1])
    return cm.logits_out(cfg, params, x), cache


def decode_step(cfg: ArchConfig, params, tokens, cache, pos: int):
    """tokens: (B, 1); pos: current length (int).  One decode step."""
    pl = tp.begin_pass(tokens.shape[1])
    x = _decoder_input(cfg, params, tokens, pl, pos)
    x, cache = _decode_stack(cfg, params, x, caches=cache, cache_pos=pos)
    x = _final(cfg, params, x)
    return cm.logits_out(cfg, params, x[:, -1]), cache


register_family("encdec")(sys.modules[__name__])
