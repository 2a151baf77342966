"""Architecture configuration + the model registry.

One ``ArchConfig`` dataclass drives every assigned architecture; family-
specific sub-configs (MoE, RNN, RWKV, encoder-decoder) are optional
fields.  Every model family implements the same functional protocol:

    init(cfg, key)                          -> params pytree
    forward(cfg, params, batch)             -> logits (B, S, V)   [train]
    init_cache(cfg, batch, max_len, dtype)  -> cache pytree
    prefill(cfg, params, batch, cache)      -> (last_logits, cache)
    decode_step(cfg, params, token, cache, pos) -> (logits, cache)

``batch`` is a dict: tokens (B, S) plus stub-frontend tensors for the
VLM / audio entries.  The port's ``init`` takes a ``torch.Generator`` and
a device in place of the reference's PRNG key.

The port implements every family of the reference: ``transformer``
(dense and MoE, ``MoeConfig``), ``griffin`` (RecurrentGemma,
``RnnConfig``), ``rwkv6`` (``RwkvConfig``) and ``encdec`` (Whisper,
``EncDecConfig``; ``batch["audio_embeds"]`` carries the stub frontend's
frame embeddings).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def round_up(x: int, m: int) -> int:
    return x + (-x) % m


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    renormalize: bool = False          # OLMoE keeps raw softmax weights
    dense_parallel: bool = False       # Arctic: dense MLP residual branch


@dataclasses.dataclass(frozen=True)
class RnnConfig:                       # Griffin / RecurrentGemma RG-LRU
    d_rnn: int
    conv_width: int = 4
    c: float = 8.0                     # log_a = -c * softplus(Λ) * sigmoid(r)
    block_pattern: "tuple[str, ...]" = ("rec", "rec", "attn")


@dataclasses.dataclass(frozen=True)
class RwkvConfig:
    head_size: int = 64
    lora_mix: int = 32                 # DDLerp low-rank dim
    lora_decay: int = 64
    lora_gate: int = 64


@dataclasses.dataclass(frozen=True)
class EncDecConfig:                    # Whisper
    n_encoder_layers: int
    n_audio_ctx: int = 1500
    learned_pos: bool = True
    # Whisper's real decoder context is 448; the assignment's shape grid
    # drives the backbone to 4k/32k, so the learned table is sized to fit.
    max_positions: int = 32768


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                        # transformer | rwkv6 | griffin | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # --- attention / block flags -----------------------------------------
    rope_theta: float = 1e4
    rms_eps: float = 1e-6
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    query_scale: Optional[float] = None      # None -> 1/sqrt(head_dim)
    window: int = 0                          # local-attention window
    layer_pattern: str = "uniform"           # uniform | gemma2_alt | griffin
    mlp_activation: str = "silu"
    mlp_glu: bool = True
    sandwich_norms: bool = False             # gemma2 pre+post norms
    rmsnorm_unit_offset: bool = False        # gemma-style (1 + w) scale
    embed_scale: bool = False                # embed * sqrt(d_model)
    tie_embeddings: bool = False
    vocab_pad_to: int = 256
    # --- family extensions -------------------------------------------------
    moe: Optional[MoeConfig] = None
    rnn: Optional[RnnConfig] = None
    rwkv: Optional[RwkvConfig] = None
    encdec: Optional[EncDecConfig] = None
    vision_prefix: int = 0                   # InternVL stub image tokens
    # --- runtime -----------------------------------------------------------
    dtype: torch.dtype = torch.bfloat16
    backend: str = "kernel"                  # kernel | torch | dense
    # (not ported: ``remat``, training-only; ``attn_pv_bf16``, a lever of
    # the reference's XLA attention; ``moe_shard_map``, with the
    # distributed slice)
    kv_cache_dtype: torch.dtype = torch.bfloat16
    attn_chunk: int = 1024                   # chunked torch attention KV block

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab_size, self.vocab_pad_to)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def sm_scale(self) -> float:
        return (self.query_scale if self.query_scale is not None
                else self.head_dim ** -0.5)

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # --- parameter counting (MODEL_FLOPS denominators) ---------------------
    def param_count(self, active_only: bool = False) -> int:
        """Approximate parameter count; active_only counts top-k experts."""
        d, v = self.d_model, self.padded_vocab
        embed = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "rwkv6":
            rw = self.rwkv
            per = (5 * d * d                          # r, k, v, g, out proj
                   + 10 * d * rw.lora_mix             # DDLerp W1/W2
                   + 2 * d * rw.lora_decay + 2 * d * rw.lora_gate
                   + 2 * d * self.d_ff + d * d)       # channel mix (k, v, r)
            return embed + self.n_layers * per
        attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        glu_mult = 2 if self.mlp_glu else 1
        dense_mlp = d * self.d_ff * glu_mult + self.d_ff * d
        per = attn + dense_mlp
        if self.moe:
            e = self.moe.top_k if active_only else self.moe.n_experts
            expert = d * self.moe.d_ff_expert * glu_mult + self.moe.d_ff_expert * d
            per = attn + e * expert + d * self.moe.n_experts
            if self.moe.dense_parallel:
                per += dense_mlp
        if self.family == "griffin":
            rn = self.rnn
            n_rec = sum(1 for i in range(self.n_layers)
                        if rn.block_pattern[i % len(rn.block_pattern)] == "rec")
            n_att = self.n_layers - n_rec
            rec = (2 * d * rn.d_rnn + rn.d_rnn * d       # in/out projections
                   + rn.conv_width * rn.d_rnn + 2 * rn.d_rnn * rn.d_rnn // 16)
            per_att = attn + dense_mlp
            per_rec = rec + dense_mlp
            return embed + n_rec * per_rec + n_att * per_att
        if self.family == "encdec":
            enc_layers = self.encdec.n_encoder_layers
            cross = attn                                  # cross-attention
            return (embed + enc_layers * per
                    + self.n_layers * (per + cross))
        return embed + self.n_layers * per


# ---------------------------------------------------------------------------
# Registry.
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register_family(name: str):
    def deco(module):
        _REGISTRY[name] = module
        return module
    return deco


def family_module(cfg: ArchConfig):
    """Resolve the functional module implementing ``cfg.family``."""
    # Import for side effects (registration); idempotent via sys.modules.
    from repro_torch.models import (recurrentgemma, rwkv6,  # noqa: F401
                                    transformer, whisper)
    if cfg.family not in _REGISTRY:
        raise NotImplementedError(
            f"unknown model family {cfg.family!r}; known: "
            f"{sorted(_REGISTRY)}")
    return _REGISTRY[cfg.family]
