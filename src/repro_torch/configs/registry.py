"""Architecture registry + the assigned shape grid + input_specs().

``ARCH_MODULES`` lists the configurations the port supports: all of the
reference's.  ``input_specs(cfg, shape, mode)`` returns ``meta`` tensors
standing for every model input (shapes and dtypes, no memory), consumed
by the dry run (``launch/dryrun.py``); ``concrete_batch`` draws a small
real one from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.base import ArchConfig

# In the reference's order, which ``all_cells`` walks.
ARCH_MODULES = {
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    # Served only through ``reduced()``: 134 GB of bf16 weights fit no
    # card (the dry run counts it on ``meta``).
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "yi-6b": "repro_torch.configs.yi_6b",
    "internvl2-1b": "repro_torch.configs.internvl2_1b",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    # Served only through ``reduced()``: 480 B parameters fit no one card.
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
}

ALL_ARCHS = tuple(ARCH_MODULES)


def get_config(name: str, reduced: bool = False, **overrides) -> ArchConfig:
    if name not in ARCH_MODULES:
        raise KeyError(f"unknown architecture {name!r}; known: "
                       f"{list(ALL_ARCHS)}")
    mod = importlib.import_module(ARCH_MODULES[name])
    cfg = mod.reduced() if reduced else mod.CONFIG
    return cfg.with_(**overrides) if overrides else cfg


# ---------------------------------------------------------------------------
# Assigned shapes (LM shapes are seq_len × global_batch).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str                 # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

#: bounded-state archs that run the long-context decode cell.
LONG_CONTEXT_ARCHS = ("rwkv6-7b", "recurrentgemma-2b")


def cell_applicable(arch: str, shape: str) -> bool:
    """Assignment rule: long_500k only for bounded-state archs."""
    if shape == "long_500k":
        return arch in LONG_CONTEXT_ARCHS
    return True


def all_cells(include_skipped: bool = False):
    for arch in ALL_ARCHS:
        for shape in SHAPES:
            if include_skipped or cell_applicable(arch, shape):
                yield arch, shape


# ---------------------------------------------------------------------------
# Abstract inputs.
# ---------------------------------------------------------------------------

def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: "ShapeSpec | str",
                mode: "str | None" = None) -> dict:
    """Abstract batch for one (arch × shape) cell, as ``meta`` tensors.

    train:   tokens + labels (B, S)         [+ stub frontend tensors]
    prefill: tokens (B, S)                  [+ stub frontend tensors]
    decode:  tokens (B, 1)                  (cache is built separately)
    """
    if isinstance(shape, str):
        shape = SHAPES[shape]
    mode = mode or shape.mode
    b, s = shape.global_batch, shape.seq_len
    specs = {}
    if mode == "decode":
        specs["tokens"] = _meta((b, 1), torch.int32)
    else:
        specs["tokens"] = _meta((b, s), torch.int32)
        if mode == "train":
            specs["labels"] = _meta((b, s), torch.int32)
    if cfg.vision_prefix and mode != "decode":
        specs["vision_embeds"] = _meta((b, cfg.vision_prefix, cfg.d_model),
                                       torch.float32)
    if cfg.encdec is not None and mode != "decode":
        specs["audio_embeds"] = _meta(
            (b, cfg.encdec.n_audio_ctx, cfg.d_model), torch.float32)
    return specs


def concrete_batch(cfg: ArchConfig, batch_size: int, seq_len: int,
                   mode: str, gen: torch.Generator) -> dict:
    """Small concrete batch for smoke tests (mirrors input_specs), on the
    CPU: token ids uniform in [0, vocab), float inputs standard normal,
    drawn from ``gen`` in the order of ``input_specs``."""
    spec = ShapeSpec("smoke", seq_len, batch_size, mode)
    out = {}
    for name, s in input_specs(cfg, spec, mode).items():
        if s.dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab_size, s.shape,
                                      generator=gen, dtype=torch.int32)
        else:
            out[name] = torch.randn(s.shape, generator=gen, dtype=s.dtype)
    return out
