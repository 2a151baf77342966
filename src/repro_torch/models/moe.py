"""Top-k MoE block (OLMoE 64e/top-8, Arctic 128e/top-2 + dense residual).

Each call sort-dispatches its tokens to the experts with capacity
``moe_capacity`` (overflow is dropped, GShard-style), runs the expert
MLPs as two grouped GEMMs and combines the outputs with the gate
weights.  ``moe_apply_local`` takes a window of experts
(``e_start``, ``wi_local.shape[0]``), as in the reference, so that the
partial outputs of disjoint windows sum to the whole.

Only the reference's single-device branch is ported: its expert-parallel
``shard_map`` branch (experts sharded over the mesh's ``model`` axis, one
``psum`` of the partial outputs) waits for the distributed slice.  Without
a mesh the reference takes the same single-device branch.
"""

from __future__ import annotations

import torch

from repro_torch.core.fusion import ACTIVATIONS, Epilogue, linear
from repro_torch.models import common as cm
from repro_torch.models.base import ArchConfig


def moe_init(cfg: ArchConfig, gen: torch.Generator, device=None):
    """Seeded parameters with the reference's distributions, fan-ins as
    it writes them: ``experts_wi`` divides by sqrt(n_experts) (its
    ``in_axis`` 0), ``experts_wo`` by sqrt(d_model)."""
    m = cfg.moe
    d = cfg.d_model
    mult = 2 if cfg.mlp_glu else 1
    kw = dict(device=device)
    p = {
        "w_router": cm.dense_init(gen, (d, m.n_experts), torch.float32, **kw),
        "experts_wi": cm.dense_init(
            gen, (m.n_experts, d, mult * m.d_ff_expert), cfg.dtype, **kw),
        "experts_wo": cm.dense_init(
            gen, (m.n_experts, m.d_ff_expert, d), cfg.dtype, in_axis=2,
            **kw),
    }
    if m.dense_parallel:
        p["dense_wi"] = cm.dense_init(gen, (d, mult * cfg.d_ff), cfg.dtype,
                                      **kw)
        p["dense_wo"] = cm.dense_init(gen, (cfg.d_ff, d), cfg.dtype,
                                      in_axis=1, **kw)
    return p


def _expert_ffn(cfg: ArchConfig, wi, wo, x, occupancy=None):
    """x: (E_l, C, d) -> (E_l, C, d) through the per-expert GLU MLP.

    ``cfg.backend == "kernel"`` runs the grouped-GEMM kernel (its plain
    version on CPU tensors); ``"torch"`` and ``"dense"`` run the einsum
    form, accumulating in fp32.  ``occupancy``: the kernel's promises of
    zero rows in ``x`` (``rows``, ``max_rows``, ``max_experts`` of
    ``grouped_matmul``), passed on to the second GEMM too where the first
    one's epilogue keeps zero rows zero.
    """
    if cfg.backend == "kernel":
        from repro_torch.kernels.moe.ops import (grouped_matmul,
                                                 keeps_zero_rows)
        occupancy = occupancy or {}
        ep = Epilogue(activation=cfg.mlp_activation, glu=cfg.mlp_glu,
                      out_dtype=x.dtype)
        h = grouped_matmul(x, wi, epilogue=ep, **occupancy)
        return grouped_matmul(h, wo,
                              **(occupancy if keeps_zero_rows(ep) else {}))
    if cfg.backend not in ("torch", "dense"):
        raise ValueError(f"unknown MoE backend {cfg.backend!r}; use "
                         "'kernel', 'torch' or 'dense'")
    h = torch.einsum("ecd,edf->ecf", x.float(), wi.float())
    act = ACTIVATIONS[cfg.mlp_activation]
    if cfg.mlp_glu:
        half = h.shape[-1] // 2
        h = act(h[..., :half]) * h[..., half:]
    else:
        h = act(h)
    h = h.to(x.dtype)
    return torch.einsum("ecf,efd->ecd", h.float(), wo.float()).to(x.dtype)


def route(cfg: ArchConfig, x2d, w_router):
    """Router: (gate (T, k) fp32, expert index (T, k)).

    The product is fp32 (TF32 must be off on the card:
    ``core.precision.disable_tf32``).  ``jax.lax.top_k`` breaks ties
    toward the lower index and ``torch.topk`` promises no order among
    ties; with fp32 softmax probabilities of continuous inputs, ties do
    not occur.
    """
    probs = torch.softmax(x2d.float() @ w_router, dim=-1)
    gate, idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    if cfg.moe.renormalize:
        gate = gate / gate.sum(dim=-1, keepdim=True)
    return gate, idx


def moe_apply_local(cfg: ArchConfig, x2d, w_router, wi_local, wo_local,
                    e_start: int, capacity: int):
    """Partial MoE output of the locally-held experts.

    x2d: (T, d); wi_local: (E_l, d, mult·ff); e_start: first owned expert.
    Returns (T, d), in x2d's dtype.
    """
    k = cfg.moe.top_k
    t, d = x2d.shape
    e_local = wi_local.shape[0]

    gate, idx = route(cfg, x2d, w_router)
    flat_idx = idx.reshape(-1)                             # (T·k,)
    flat_gate = gate.reshape(-1)
    local_e = torch.where(
        (flat_idx >= e_start) & (flat_idx < e_start + e_local),
        flat_idx - e_start, e_local)                       # e_local = trash

    # Stable, as jnp.argsort: the order decides which tokens overflow.
    order = torch.argsort(local_e, stable=True)
    sorted_e = local_e[order]
    counts = torch.bincount(local_e, minlength=e_local + 1)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * k, device=x2d.device) - starts[sorted_e]
    keep = (sorted_e < e_local) & (rank < capacity)
    trash = e_local * capacity
    slot = torch.where(keep, sorted_e * capacity + rank, trash)
    token = order // k

    # Dropped entries all write the trash row, which is then cut off.
    disp = torch.zeros((trash + 1, d), dtype=x2d.dtype, device=x2d.device)
    disp[slot] = torch.where(keep[:, None], x2d[token], 0.0).to(x2d.dtype)
    disp = disp[:-1].reshape(e_local, capacity, d)

    # Expert e's kept tokens fill rows [0, rows[e]) of its capacity block
    # and the rest stay zero; top-k picks distinct experts per token, so
    # no expert holds more than t rows, and at most t * k experts hold one.
    occupancy = dict(
        rows=torch.clamp(counts[:e_local], max=capacity).to(torch.int32),
        max_rows=min(capacity, t), max_experts=min(e_local, t * k))
    y = _expert_ffn(cfg, wi_local, wo_local, disp,
                    occupancy)                             # (E_l, C, d)
    y_flat = y.reshape(trash, d)

    contrib = torch.where(
        keep[:, None],
        flat_gate[order][:, None].to(x2d.dtype)
        * y_flat[torch.clamp(slot, max=trash - 1)], 0.0).to(x2d.dtype)
    # The reference scatter-adds ``contrib`` into zeros in its sorted
    # order.  Atomics would make the order, and so the rounding in
    # x2d's dtype, change from run to run; instead each token's k
    # contributions are gathered, in that same sorted order, and added
    # one after another.
    per_token = contrib[torch.argsort(token, stable=True)].reshape(t, k, d)
    out = torch.zeros((t, d), dtype=x2d.dtype, device=x2d.device)
    for j in range(k):
        out = out + per_token[:, j]
    return out


def moe_capacity(cfg: ArchConfig, tokens_local: int) -> int:
    m = cfg.moe
    cap = int(tokens_local * m.top_k * m.capacity_factor / m.n_experts) + 1
    return max(8, cap + (-cap) % 8)


def moe_apply(cfg: ArchConfig, p, x):
    """x: (B, S, d) -> (B, S, d): all experts on this device."""
    b, s, d = x.shape
    capacity = moe_capacity(cfg, b * s)
    y = moe_apply_local(cfg, x.reshape(-1, d), p["w_router"],
                        p["experts_wi"], p["experts_wo"], 0,
                        capacity).reshape(b, s, d)
    if cfg.moe.dense_parallel:
        # Arctic: dense residual MLP in parallel with the MoE branch.
        h = linear(x, p["dense_wi"], activation=cfg.mlp_activation,
                   glu=cfg.mlp_glu)
        y = y + linear(h, p["dense_wo"])
    return y
