"""Architecture registry of the port.

``ARCH_MODULES`` lists the configurations the port supports: all of the
reference's.  The reference's shape grid and abstract ``input_specs`` serve its
dry-run and roofline tools, which are not ported yet.
"""

from __future__ import annotations

import importlib

from repro_torch.models.base import ArchConfig

ARCH_MODULES = {
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    # Run only through ``reduced()``: 134 GB of bf16 weights fit no card.
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "yi-6b": "repro_torch.configs.yi_6b",
    "internvl2-1b": "repro_torch.configs.internvl2_1b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    # Run only through ``reduced()``: 480 B parameters fit no one card.
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
}

ALL_ARCHS = tuple(ARCH_MODULES)


def get_config(name: str, reduced: bool = False, **overrides) -> ArchConfig:
    if name not in ARCH_MODULES:
        raise KeyError(f"unknown architecture {name!r}; known: "
                       f"{list(ALL_ARCHS)}")
    mod = importlib.import_module(ARCH_MODULES[name])
    cfg = mod.reduced() if reduced else mod.CONFIG
    return cfg.with_(**overrides) if overrides else cfg
