"""Architecture registry of the port.

``ARCH_MODULES`` lists only the configurations the port supports so far.
The reference's shape grid and abstract ``input_specs`` serve its
dry-run and roofline tools, which are not ported yet.
"""

from __future__ import annotations

import importlib

from repro_torch.models.base import ArchConfig

ARCH_MODULES = {
    "yi-6b": "repro_torch.configs.yi_6b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    # Run only through ``reduced()``: 480 B parameters fit no one card.
    "arctic-480b": "repro_torch.configs.arctic_480b",
}

ALL_ARCHS = tuple(ARCH_MODULES)


def get_config(name: str, reduced: bool = False, **overrides) -> ArchConfig:
    if name not in ARCH_MODULES:
        raise NotImplementedError(f"architecture {name!r} is not ported yet; "
                                  f"ported: {list(ALL_ARCHS)}")
    mod = importlib.import_module(ARCH_MODULES[name])
    cfg = mod.reduced() if reduced else mod.CONFIG
    return cfg.with_(**overrides) if overrides else cfg
