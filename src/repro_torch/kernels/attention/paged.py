"""Paged attention over a block-table KV layout (the vLLM idiom).

The serving stack's :mod:`repro_torch.serving.kvcache` allocator hands
out fixed-size KV blocks from a shared physical pool; this module closes
the execution loop: the cache lives as a **page pool** ``(P, Hkv,
block_tokens, D)`` plus a per-sequence **block table** ``(B, n_blocks)``
of page indices, and attention gathers the pages back into the
contiguous ``(B, Hkv, S, D)`` layout before running *exactly* the same
math as the contiguous call (``decode_attention`` for the single-token
path, ``flash_attention`` for K2 on the card).  Because the gather is a
pure permutation of rows followed by the identical kernel, paged outputs
are **bit-identical** to the contiguous path on the CPU and on the card.

The page shuffle is ``random.Random(seed)``, as in the reference, so a
seed gives the reference's block table.
"""

from __future__ import annotations

import random
from typing import Optional

import torch

from repro_torch.kernels.attention.ops import (_pad_axis, decode_attention,
                                               flash_attention)


def to_paged(k_cache, v_cache, block_tokens: int, *, seed: int = 0):
    """Scatter contiguous caches ``(B, Hkv, S, D)`` into a paged pool.

    Returns ``(k_pages, v_pages, block_table)`` with pages of shape
    ``(B * n_blocks, Hkv, block_tokens, D)`` and an int32 table
    ``(B, n_blocks)`` on the caches' device.  ``seed`` shuffles the
    physical page order (the allocator's seeded free list does the
    same), so round-tripping goes through a *non-trivial* table.  ``S``
    is zero-padded up to a block multiple; padded positions sit past
    every ``cache_len`` so the attention mask ignores them.
    """
    if block_tokens < 1:
        raise ValueError(f"block_tokens must be >= 1, got {block_tokens}")
    if k_cache.shape != v_cache.shape:
        raise ValueError(f"k/v shape mismatch: {tuple(k_cache.shape)} vs "
                         f"{tuple(v_cache.shape)}")
    b, hkv, s, d = k_cache.shape
    n_blocks = -(-s // block_tokens)
    kp = _pad_axis(k_cache, 2, block_tokens)
    vp = _pad_axis(v_cache, 2, block_tokens)
    total = b * n_blocks
    # logical block i of sequence q lives at physical page perm[q*nb+i].
    perm = list(range(total))
    random.Random(seed).shuffle(perm)
    perm = torch.tensor(perm, dtype=torch.int64)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(total)
    inv = inv.to(k_cache.device)

    def paginate(x):
        blocks = x.reshape(b, hkv, n_blocks, block_tokens, d)
        blocks = blocks.permute(0, 2, 1, 3, 4)
        blocks = blocks.reshape(total, hkv, block_tokens, d)
        return blocks[inv]                     # page p holds block inv[p]

    block_table = perm.reshape(b, n_blocks).to(torch.int32).to(
        k_cache.device)
    return paginate(kp), paginate(vp), block_table


def gather_paged(pages, block_table, seq_len: Optional[int] = None):
    """Gather a paged pool back to the contiguous ``(B, Hkv, S, D)``
    layout: ``pages[block_table]`` per sequence, blocks re-ordered by
    table position, cropped to ``seq_len``.  The result is contiguous,
    so a kernel reads it with the strides of a contiguous cache."""
    g = pages[block_table.long()]              # (B, nb, Hkv, bt, D)
    b, nb, hkv, bt, d = g.shape
    out = g.permute(0, 2, 1, 3, 4).reshape(b, hkv, nb * bt, d)
    if seq_len is not None and seq_len < nb * bt:
        out = out[:, :, :seq_len].contiguous()
    return out


def paged_decode_attention(q, k_pages, v_pages, block_table, cache_len, *,
                           seq_len: Optional[int] = None,
                           sm_scale: Optional[float] = None,
                           window: int = 0, softcap: float = 0.0):
    """Single-token decode against a paged cache — bit-identical to
    ``decode_attention`` on the gathered-contiguous layout (padded
    positions past ``cache_len`` are masked before the softmax, so the
    block-padding tail never contributes)."""
    k = gather_paged(k_pages, block_table, seq_len)
    v = gather_paged(v_pages, block_table, seq_len)
    return decode_attention(q, k, v, cache_len, sm_scale=sm_scale,
                            window=window, softcap=softcap)


def paged_flash_attention(q, k_pages, v_pages, block_table, *,
                          seq_len: Optional[int] = None, **kw):
    """Prefill/chunk attention against a paged cache through
    ``flash_attention`` (K2 on CUDA tensors) — the gather is a row
    permutation into fresh contiguous memory, so the kernel sees
    byte-identical operands to the contiguous call."""
    k = gather_paged(k_pages, block_table, seq_len)
    v = gather_paged(v_pages, block_table, seq_len)
    return flash_attention(q, k, v, **kw)
