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
Activation remat is training-only and not ported; the reference's
``constrain`` sharding annotations are no-ops without a mesh and dropped.
"""

from __future__ import annotations

import sys
from typing import Optional

import torch

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
    return cm.rmsnorm(x, w, cfg.rms_eps, cfg.rmsnorm_unit_offset)


def block_apply(cfg: ArchConfig, p, x, *, positions, window: int,
                kv_cache=None, cache_pos: Optional[int] = None):
    """x: (B, S, d) -> (B, S, d).  ``kv_cache`` (k, v) is written in place
    at ``cache_pos``."""
    h = _norm(cfg, x, p["ln_attn"])
    q, k, v = cm.qkv_project(cfg, p["attn"], h, positions)

    if kv_cache is not None:
        k_cache, v_cache = cm.cache_update(*kv_cache, k, v, cache_pos)
        if q.shape[2] == 1:                      # decode: one new token
            from repro_torch.kernels.attention.ops import decode_attention
            ctx = decode_attention(
                q, k_cache, v_cache, cache_pos + 1,
                sm_scale=cfg.sm_scale, window=window,
                softcap=cfg.attn_softcap)
        else:                                    # prefill writes + attends
            ctx = cm.attention(cfg, q, k, v, causal=True, window=window)
    else:
        ctx = cm.attention(cfg, q, k, v, causal=True, window=window)

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

def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_zip(fn, a, b):
    if isinstance(a, dict):
        for k in a:
            _tree_zip(fn, a[k], b[k])
    else:
        fn(a, b)


def _stack_init(cfg: ArchConfig, gen: torch.Generator, n: int, device):
    """``n`` blocks stacked on a leading axis, filled one block at a time
    so that only one block's temporaries exist besides the stack."""
    first = block_init(cfg, gen, device)
    stack = _tree_map(lambda x: torch.empty((n, *x.shape), dtype=x.dtype,
                                            device=x.device), first)
    _tree_zip(lambda s, x: s[0].copy_(x), stack, first)
    del first
    for i in range(1, n):
        _tree_zip(lambda s, x: s[i].copy_(x), stack,
                  block_init(cfg, gen, device))
    return stack


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
        _stack_init(cfg, gen, cfg.n_layers // group, device)
        for _ in range(group))
    return params


def _layer(tree, i: int):
    return _tree_map(lambda x: x[i], tree)


def _run_blocks(cfg: ArchConfig, params, x, *, positions, caches=None,
                cache_pos=None):
    """Walk the layer *groups* in order; each step applies the whole group
    (so gemma2's (local, global) pairs stay interleaved).  KV caches are
    updated in place and returned per group, as the reference's scan ys."""
    wins = _windows(cfg)
    n = cfg.n_layers // len(wins)
    for j in range(n):
        for i, window in enumerate(wins):
            kv = None
            if caches is not None:
                kv = (caches[i][0][j], caches[i][1][j])
            x = block_apply(cfg, _layer(params["layers"][i], j), x,
                            positions=positions, window=window,
                            kv_cache=kv, cache_pos=cache_pos)
    return x, caches


# ---------------------------------------------------------------------------
# Public protocol.
# ---------------------------------------------------------------------------

def _embed_inputs(cfg: ArchConfig, params, batch):
    tokens = batch["tokens"]
    x = cm.embed_tokens(cfg, params["embedding"], tokens)
    if cfg.vision_prefix:
        # Stub ViT frontend: precomputed patch embeddings replace the
        # first ``vision_prefix`` positions.
        vis = batch["vision_embeds"].to(x.dtype)
        x = torch.cat([vis, x[:, cfg.vision_prefix:]], dim=1)
    return x


def forward(cfg: ArchConfig, params, batch):
    """Full-sequence forward (evaluation)."""
    x = _embed_inputs(cfg, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = _run_blocks(cfg, params, x, positions=positions)
    x = _norm(cfg, x, params["ln_final"])
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
    x = _embed_inputs(cfg, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    x, cache = _run_blocks(cfg, params, x, positions=positions,
                           caches=cache, cache_pos=0)
    x = _norm(cfg, x, params["ln_final"])
    return cm.logits_out(cfg, params, x[:, -1]), cache


def decode_step(cfg: ArchConfig, params, tokens, cache, pos: int):
    """tokens: (B, 1); pos: current length (int).  One decode step."""
    x = cm.embed_tokens(cfg, params["embedding"], tokens)
    positions = torch.full((tokens.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    x, cache = _run_blocks(cfg, params, x, positions=positions,
                           caches=cache, cache_pos=pos)
    x = _norm(cfg, x, params["ln_final"])
    return cm.logits_out(cfg, params, x[:, -1]), cache


register_family("transformer")(sys.modules[__name__])
