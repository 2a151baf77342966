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
are dropped: without a device mesh they are no-ops.
"""

from __future__ import annotations

import math

import torch

from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core import tree
from repro_torch.core.fusion import linear
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


def qkv_project(cfg: ArchConfig, p, x, positions):
    """x: (B, S, d) -> q (B, H, S, hd), k/v (B, Hkv, S, hd) with RoPE."""
    b, s, _ = x.shape
    q = linear(x, p["wq"], p.get("bq"), backend=_mm_backend(cfg))
    k = linear(x, p["wk"], p.get("bk"), backend=_mm_backend(cfg))
    v = linear(x, p["wv"], p.get("bv"), backend=_mm_backend(cfg))
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim).transpose(1, 2)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim).transpose(1, 2)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim).transpose(1, 2)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.rms_eps)
        k = rmsnorm(k, p["k_norm"], cfg.rms_eps)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_out(cfg: ArchConfig, p, ctx):
    """ctx: (B, H, S, hd) -> (B, S, d)."""
    b, h, s, hd = ctx.shape
    ctx = ctx.transpose(1, 2).reshape(b, s, h * hd)
    return linear(ctx, p["wo"], backend=_mm_backend(cfg))


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
    h = linear(x, p["wi"], activation=cfg.mlp_activation, glu=cfg.mlp_glu,
               backend=_mm_backend(cfg))
    return linear(h, p["wo"], backend=_mm_backend(cfg))


# ---------------------------------------------------------------------------
# Embedding / logits.
# ---------------------------------------------------------------------------

def embed_tokens(cfg: ArchConfig, embedding, tokens):
    x = embedding[tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model),
                             dtype=torch.float32).to(x.dtype)
    return x


def logits_out(cfg: ArchConfig, params, x):
    w = (params["embedding"].T if cfg.tie_embeddings
         else params["lm_head"])
    return linear(x, w, softcap=cfg.final_softcap, out_dtype=torch.float32,
                  backend=_mm_backend(cfg))


# ---------------------------------------------------------------------------
# KV cache helpers (dense buffer, optionally quantized dtype).
# ---------------------------------------------------------------------------

def cache_update(k_cache, v_cache, k_new, v_new, pos: int):
    """Write (B, Hkv, S_new, D) at position ``pos`` along the S axis.

    Writes in place (the reference returns new arrays): a serving cache
    is updated every step, and a copy per step would double its memory.
    Returns the same two tensors.
    """
    s_new, cap = k_new.shape[2], k_cache.shape[2]
    if not 0 <= pos <= cap - s_new:
        raise ValueError(f"cache write of {s_new} at {pos} exceeds its "
                         f"length {cap}")
    k_cache[:, :, pos:pos + s_new] = k_new.to(k_cache.dtype)
    v_cache[:, :, pos:pos + s_new] = v_new.to(v_cache.dtype)
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
