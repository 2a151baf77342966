"""Generic decoder-only transformer family (the port's dense slice).

One implementation, flag-driven, as in the reference: pre-RMSNorm,
SwiGLU/GeGLU MLP or a top-k MoE block (``models/moe.py``), RoPE with
GQA, optional sandwich norms, soft-caps, QKV bias, QK-norm and
tied/scaled embeddings.  yi-6b (the Llama architecture), olmoe-1b-7b
and arctic-480b (reduced) are the configurations ported so far; the
gemma2 and internvl2 flags are held against the reference's reduced
configs in the tests.

Layer parameters are stacked on a leading layer axis, as in the
reference, and a Python loop walks the stack where the reference runs
``lax.scan``; gemma2's alternating pattern walks (local, global) *pairs*.
Activation remat wraps each pair (``common.remat``) where autograd tracks
the forward.  The reference's ``constrain`` sharding annotations are
dropped: under a mesh this process is a rank of, each block runs on the
rank's shards (``distributed.tensor_parallel``), and where the rules map
``seq`` to ``model`` the residual stream between blocks holds the rank's
share of the sequence (``tensor_parallel.begin_pass``).
"""

from __future__ import annotations

import sys
from typing import Optional

import torch

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import common as cm
from repro_torch.models import moe as moe_lib
from repro_torch.models.base import ArchConfig, register_family


# ---------------------------------------------------------------------------
# One block.
# ---------------------------------------------------------------------------

def block_init(cfg: ArchConfig, gen: torch.Generator, device=None):
    kw = dict(dtype=cfg.dtype, device=device)
    norm = torch.zeros if cfg.rmsnorm_unit_offset else torch.ones
    p = {
        "attn": cm.attn_init(cfg, gen, device),
        "ln_attn": norm((cfg.d_model,), **kw),
        "ln_mlp": norm((cfg.d_model,), **kw),
    }
    if cfg.moe is not None:
        p["moe"] = moe_lib.moe_init(cfg, gen, device)
    else:
        p["mlp"] = cm.mlp_init(cfg, gen, device)
    if cfg.sandwich_norms:
        p["ln_attn_post"] = norm((cfg.d_model,), **kw)
        p["ln_mlp_post"] = norm((cfg.d_model,), **kw)
    return p


def _norm(cfg, x, w):
    return cm.rmsnorm(x, cm.stream_leaf(w), cfg.rms_eps,
                      cfg.rmsnorm_unit_offset)


def block_apply(cfg: ArchConfig, p, x, *, positions, window: int,
                kv_cache=None, cache_pos: Optional[int] = None,
                shard: Optional[tp.CacheShard] = None):
    """x: (B, S, d) -> (B, S, d).  ``kv_cache`` (k, v) is written in place
    at ``cache_pos``.  Under sequence parallelism ``x`` holds the rank's
    share of the sequence (``positions`` stay the whole sequence's).
    ``shard`` (under a mesh) says where the rank's cache lies in the
    whole (``common.self_attention``)."""
    h = _norm(cfg, x, p["ln_attn"])
    ctx = cm.self_attention(cfg, p["attn"], h, positions, window=window,
                            kv_cache=kv_cache, cache_pos=cache_pos,
                            shard=shard)
    attn_out = cm.attn_out(cfg, p["attn"], ctx)
    if cfg.sandwich_norms:
        attn_out = _norm(cfg, attn_out, p["ln_attn_post"])
    x = x + attn_out

    h = _norm(cfg, x, p["ln_mlp"])
    if cfg.moe is not None:
        mlp_out = moe_lib.moe_apply(cfg, p["moe"], h)
    else:
        mlp_out = cm.mlp_apply(cfg, p["mlp"], h)
    if cfg.sandwich_norms:
        mlp_out = _norm(cfg, mlp_out, p["ln_mlp_post"])
    return x + mlp_out


# ---------------------------------------------------------------------------
# Layer stacking: uniform stack or gemma2 (local, global) pairs.
# ---------------------------------------------------------------------------

def _windows(cfg: ArchConfig):
    if cfg.layer_pattern == "gemma2_alt":
        return (cfg.window, 0)                   # local then global
    return (cfg.window,)


def init(cfg: ArchConfig, gen: torch.Generator, device=None):
    """Seeded random parameters with the reference's distributions."""
    v = cfg.padded_vocab
    norm = torch.zeros if cfg.rmsnorm_unit_offset else torch.ones
    params = {
        "embedding": cm.embed_init(gen, (v, cfg.d_model), cfg.dtype, device),
        "ln_final": norm((cfg.d_model,), dtype=cfg.dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = cm.dense_init(gen, (cfg.d_model, v), cfg.dtype,
                                          device=device)
    group = len(_windows(cfg))
    if cfg.n_layers % group:
        raise ValueError(f"{cfg.n_layers} layers do not split into groups "
                         f"of {group}")
    params["layers"] = tuple(
        cm.stack_init(lambda: block_init(cfg, gen, device),
                      cfg.n_layers // group)
        for _ in range(group))
    return params


def _run_blocks(cfg: ArchConfig, params, x, *, positions, caches=None,
                cache_pos=None):
    """Walk the layer *groups* in order; each step applies the whole group
    (so gemma2's (local, global) pairs stay interleaved) under
    ``cm.remat``, as the reference remats its scan body.  KV caches are
    updated in place and returned per group, as the reference's scan ys."""
    wins = _windows(cfg)
    n = cfg.n_layers // len(wins)

    pl = tp.current() if caches is not None else None
    shards = tuple(pl.cache_shard(cfg, c[0]) if pl is not None else None
                   for c in (caches or (None,) * len(wins)))

    def group(x, lps, kvs):
        for i, window in enumerate(wins):
            x = block_apply(cfg, lps[i], x, positions=positions,
                            window=window, kv_cache=kvs[i],
                            cache_pos=cache_pos, shard=shards[i])
        return x

    for j in range(n):
        lps = tuple(cm.layer(p, j) for p in params["layers"])
        kvs = tuple((c[0][j], c[1][j]) if caches is not None else None
                    for c in (caches or (None,) * len(wins)))
        x = cm.remat(cfg, group, x, lps, kvs)
    return x, caches


# ---------------------------------------------------------------------------
# Public protocol.
# ---------------------------------------------------------------------------

def _embed_inputs(cfg: ArchConfig, params, batch):
    tokens = batch["tokens"]
    x = cm.embed_tokens(cfg, params["embedding"], tokens)
    if cfg.vision_prefix:
        # Stub ViT frontend: precomputed patch embeddings replace the
        # first ``vision_prefix`` positions; under sequence parallelism
        # those of them that fall in the rank's share of the sequence.
        vis = batch["vision_embeds"].to(x.dtype)
        pl, lo = tp.current(), 0
        if pl is not None and pl.seq:
            lo = pl.rank * x.shape[1]
        n = min(max(cfg.vision_prefix - lo, 0), x.shape[1])
        x = torch.cat([vis[:, lo:lo + n], x[:, n:]], dim=1)
    return x


def forward(cfg: ArchConfig, params, batch, return_hidden: bool = False):
    """Full-sequence forward (training / evaluation); ``return_hidden``
    stops at the final norm, for the chunked loss (under sequence
    parallelism the rank's share of the sequence, which the loss
    gathers)."""
    tp.begin_pass(batch["tokens"].shape[1])
    x = _embed_inputs(cfg, params, batch)
    positions = torch.arange(batch["tokens"].shape[1], device=x.device)
    x, _ = _run_blocks(cfg, params, x, positions=positions)
    x = _norm(cfg, x, params["ln_final"])
    if return_hidden:
        return x
    return cm.logits_out(cfg, params, x)


def init_cache(cfg: ArchConfig, batch_size: int, max_len: int,
               dtype=None, device=None):
    dtype = dtype or cfg.kv_cache_dtype
    group = len(_windows(cfg))
    n = cfg.n_layers // group
    shape = (n, batch_size, cfg.n_kv_heads, max_len, cfg.head_dim)
    return tuple((torch.zeros(shape, dtype=dtype, device=device),
                  torch.zeros(shape, dtype=dtype, device=device))
                 for _ in range(group))


def prefill(cfg: ArchConfig, params, batch, cache):
    """Process the prompt, fill the cache, return last-position logits."""
    pl = tp.begin_pass(batch["tokens"].shape[1])
    x = _embed_inputs(cfg, params, batch)
    positions = torch.arange(batch["tokens"].shape[1], device=x.device)
    x, cache = _run_blocks(cfg, params, x, positions=positions,
                           caches=cache, cache_pos=0)
    x = _norm(cfg, x, params["ln_final"])
    if pl is not None:                      # the last token's rank's share
        x = pl.whole_sequence(x)
    return cm.logits_out(cfg, params, x[:, -1]), cache


def decode_step(cfg: ArchConfig, params, tokens, cache, pos: int):
    """tokens: (B, 1); pos: current length (int).  One decode step."""
    tp.begin_pass(tokens.shape[1])
    x = cm.embed_tokens(cfg, params["embedding"], tokens)
    positions = torch.full((tokens.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    x, cache = _run_blocks(cfg, params, x, positions=positions,
                           caches=cache, cache_pos=pos)
    x = _norm(cfg, x, params["ln_final"])
    return cm.logits_out(cfg, params, x[:, -1]), cache


register_family("transformer")(sys.modules[__name__])
