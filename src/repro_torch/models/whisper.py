"""Whisper-tiny encoder-decoder (audio) — backbone only, conv stub.

The conv frontend is a STUB, as in the reference: the caller supplies
precomputed frame embeddings (B, n_audio_ctx, d) in place of mel →
conv1d×2 → GELU.  The backbone is faithful Whisper: pre-LN transformer,
learned positional embeddings, bidirectional encoder, decoder with
causal self-attention and cross-attention, tied output embedding.

Serving: prefill runs the encoder once and caches each decoder layer's
cross-attention K/V; decode appends to the causal self-attention cache
(``decode_attention``, plain ops) and attends to the cached cross K/V
through ``cm.attention`` — K2 on the kernel route, one query row
against ``n_audio_ctx`` keys.

Layer parameters are stacked on a leading layer axis (``enc_layers``,
``dec_layers``), as in the reference, and a Python loop walks the stack
where the reference runs ``lax.scan`` / ``vmap``.  Activation remat is
training-only and not ported.  The decoder's cross-attention
projections call ``linear`` without a route, as the reference does, so
they resolve it through the tuned dispatch by shape.
"""

from __future__ import annotations

import sys

import torch

from repro_torch.core.fusion import linear
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


def encode(cfg: ArchConfig, params, audio_embeds):
    """audio_embeds: (B, Ta, d) — the stub conv output."""
    x = audio_embeds.to(cfg.dtype)
    x = x + params["pos_enc"][None, : x.shape[1]]
    for j in range(cfg.encdec.n_encoder_layers):
        lp = cm.layer(params["enc_layers"], j)
        h = cm.layernorm(x, lp["ln"], lp["ln_b"])
        q, k, v = cm.qkv_project(cfg, lp["attn"], h, None)
        ctx = cm.attention(cfg, q, k, v, causal=False)
        x = x + cm.attn_out(cfg, lp["attn"], ctx)
        h = cm.layernorm(x, lp["ln_mlp"], lp["ln_mlp_b"])
        x = x + cm.mlp_apply(cfg, lp["mlp"], h)
    return cm.layernorm(x, params["ln_enc_final"], params["ln_enc_final_b"])


def _cross_kv(cfg: ArchConfig, lp, enc_out):
    """One decoder layer's cross-attention K and V, (B, Hkv, Ta, hd)."""
    b = enc_out.shape[0]
    k = linear(enc_out, lp["cross"]["wk"]).reshape(
        b, -1, cfg.n_kv_heads, cfg.head_dim).transpose(1, 2)
    v = linear(enc_out, lp["cross"]["wv"]).reshape(
        b, -1, cfg.n_kv_heads, cfg.head_dim).transpose(1, 2)
    return k, v


def _dec_block(cfg: ArchConfig, lp, x, enc_out=None, cross_kv=None,
               self_kv=None, cache_pos=None):
    """x: (B, S, d) -> (B, S, d).  ``self_kv`` (k, v) is written in place
    at ``cache_pos``; ``cross_kv`` is the cached cross K/V, else it is
    projected from ``enc_out``."""
    h = cm.layernorm(x, lp["ln"], lp["ln_b"])
    q, k, v = cm.qkv_project(cfg, lp["attn"], h, None)
    if self_kv is not None:
        k_c, v_c = cm.cache_update(*self_kv, k, v, cache_pos)
        if q.shape[2] == 1:                      # decode: one new token
            from repro_torch.kernels.attention.ops import decode_attention
            ctx = decode_attention(q, k_c, v_c, cache_pos + 1,
                                   sm_scale=cfg.sm_scale)
        else:
            ctx = cm.attention(cfg, q, k, v, causal=True)
    else:
        ctx = cm.attention(cfg, q, k, v, causal=True)
    x = x + cm.attn_out(cfg, lp["attn"], ctx)

    h = cm.layernorm(x, lp["ln_cross"], lp["ln_cross_b"])
    qc = linear(h, lp["cross"]["wq"]).reshape(
        h.shape[0], h.shape[1], cfg.n_heads, cfg.head_dim).transpose(1, 2)
    kc, vc = cross_kv if cross_kv is not None else _cross_kv(cfg, lp,
                                                             enc_out)
    ctx = cm.attention(cfg, qc, kc, vc, causal=False)
    x = x + cm.attn_out(cfg, lp["cross"], ctx)

    h = cm.layernorm(x, lp["ln_mlp"], lp["ln_mlp_b"])
    return x + cm.mlp_apply(cfg, lp["mlp"], h)


def _decode_stack(cfg: ArchConfig, params, x, enc_out=None, caches=None,
                  cache_pos=None):
    """Walk the decoder layers; with ``caches`` each layer reads its
    cached cross K/V and writes its self-attention K/V in place."""
    for j in range(cfg.n_layers):
        lp = cm.layer(params["dec_layers"], j)
        if caches is None:
            x = _dec_block(cfg, lp, x, enc_out=enc_out)
        else:
            (ks, vs), (kc, vc) = caches["self"], caches["cross"]
            x = _dec_block(cfg, lp, x, cross_kv=(kc[j], vc[j]),
                           self_kv=(ks[j], vs[j]), cache_pos=cache_pos)
    return x, caches


def _final(cfg: ArchConfig, params, x):
    return cm.layernorm(x, params["ln_final"], params["ln_final_b"])


def forward(cfg: ArchConfig, params, batch, return_hidden: bool = False):
    """batch: tokens (B, S) + audio_embeds (B, Ta, d)."""
    enc_out = encode(cfg, params, batch["audio_embeds"])
    x = cm.embed_tokens(cfg, params["embedding"], batch["tokens"])
    x = x + params["pos_dec"][None, : x.shape[1]]
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
    """Encode the audio, cache every decoder layer's cross K/V, run the
    decoder over the prompt; returns last-position logits and the
    cache (written in place)."""
    enc_out = encode(cfg, params, batch["audio_embeds"])
    kc, vc = cache["cross"]
    for j in range(cfg.n_layers):
        k, v = _cross_kv(cfg, cm.layer(params["dec_layers"], j), enc_out)
        kc[j].copy_(k)
        vc[j].copy_(v)
    x = cm.embed_tokens(cfg, params["embedding"], batch["tokens"])
    x = x + params["pos_dec"][None, : x.shape[1]]
    x, cache = _decode_stack(cfg, params, x, caches=cache, cache_pos=0)
    x = _final(cfg, params, x)
    return cm.logits_out(cfg, params, x[:, -1]), cache


def decode_step(cfg: ArchConfig, params, tokens, cache, pos: int):
    """tokens: (B, 1); pos: current length (int).  One decode step."""
    x = cm.embed_tokens(cfg, params["embedding"], tokens)
    x = x + params["pos_dec"][pos:pos + 1][None]
    x, cache = _decode_stack(cfg, params, x, caches=cache, cache_pos=pos)
    x = _final(cfg, params, x)
    return cm.logits_out(cfg, params, x[:, -1]), cache


register_family("encdec")(sys.modules[__name__])
