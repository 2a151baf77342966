"""The model zoo's default matmul route.

``core.fusion.linear`` / ``cute_matmul`` calls without an explicit route
resolve it here, so one call re-routes every projection of the port.
Two executing routes exist: ``"kernel"`` (the hand-written CUDA fused
matmul; the default, so the main path runs through the kernel without a
flag) and ``"torch"`` (plain ``torch.matmul`` plus the epilogue as tensor
ops).  The reference registry's ``Backend`` protocol, its modelling
backends and its tuned dispatch are not ported yet.
"""

from __future__ import annotations

from typing import Optional

#: executing routes, each also its ``cute_matmul(backend=...)`` string.
ROUTES = ("kernel", "torch")

_DEFAULT_MATMUL = "kernel"


def set_default_matmul_backend(name: str) -> str:
    """Route the zoo's ``linear``/``cute_matmul`` calls through ``name``.
    Returns the previous setting."""
    global _DEFAULT_MATMUL
    if name not in ROUTES:
        raise ValueError(f"unknown matmul route {name!r}; one of "
                         f"{sorted(ROUTES)}")
    prev, _DEFAULT_MATMUL = _DEFAULT_MATMUL, name
    return prev


def default_matmul_backend() -> str:
    return _DEFAULT_MATMUL


def matmul_backend_string(name: Optional[str] = None) -> str:
    """The ``cute_matmul(backend=...)`` string for a route name
    (``None``: the process-wide default)."""
    name = name or _DEFAULT_MATMUL
    if name not in ROUTES:
        raise ValueError(f"unknown matmul route {name!r}; one of "
                         f"{sorted(ROUTES)}")
    return name
