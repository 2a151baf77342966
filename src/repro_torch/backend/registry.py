"""Backend registry: names -> Backend classes, and the zoo's default
matmul route.

``get("desim", unit=..., granularity="panel")`` is the one lookup every
front door goes through; registering a new engine is a
``@register("name")`` decoration away.  ``ALIASES`` accepts the
reference's spellings: ``"jax"`` and ``"xla"`` name the plain-ops route
``"torch"``, ``"pallas"`` the CUDA kernel route ``"kernel"``, and
``"analytic"`` the closed form ``"analytical"``.

The reference's tuned capability dispatch (``get_tuned``,
``tuned_config``, ...) needs its ``tune`` package, which the port has not
carried over yet.
"""

from __future__ import annotations

from typing import Callable, Optional, Type

from repro_torch.backend.base import Backend

_REGISTRY: "dict[str, Type[Backend]]" = {}

#: the reference's backend names -> the port's registry names.
ALIASES = {"analytic": "analytical", "jax": "torch", "xla": "torch",
           "pallas": "kernel"}


def register(name: str, *,
             override: bool = False) -> Callable[[Type[Backend]],
                                                 Type[Backend]]:
    """Register a Backend class under ``name``.

    Re-registering the *same* class is idempotent (module re-import
    safety); registering a different class under a taken name raises
    unless ``override=True``.
    """
    def deco(cls: Type[Backend]) -> Type[Backend]:
        existing = _REGISTRY.get(name)
        if existing is not None and existing is not cls and not override:
            raise ValueError(
                f"backend name {name!r} already registered to "
                f"{existing.__name__}; pass register({name!r}, "
                f"override=True) to replace it")
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def resolve(name: str) -> str:
    canon = ALIASES.get(name, name)
    if canon not in _REGISTRY:
        raise KeyError(
            f"unknown backend {name!r}; registered: {available()} "
            f"(aliases: {dict(ALIASES)})")
    return canon


def get(name: str, **kwargs) -> Backend:
    """Instantiate a registered backend by name (aliases accepted)."""
    return _REGISTRY[resolve(name)](**kwargs)


def available() -> "tuple[str, ...]":
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# The model zoo's matmul route.  ``core.fusion.linear`` / ``cute_matmul``
# calls without an explicit route resolve it here.  The default is the
# CUDA kernel, so the main path runs through it without a flag; on CPU
# tensors the kernel's wrapper runs its plain version.
# ---------------------------------------------------------------------------

_DEFAULT_MATMUL = "kernel"


def set_default_matmul_backend(name: str) -> str:
    """Route the zoo's ``linear``/``cute_matmul`` calls through an
    executing backend.  Returns the previous setting."""
    global _DEFAULT_MATMUL
    canon = resolve(name)
    cls = _REGISTRY[canon]
    if not cls.executes or cls.models_time:
        raise ValueError(
            f"backend {canon!r} is not an eager matmul route for the "
            "model zoo; use 'kernel' or 'torch' (modelling backends price "
            "schedules, they don't serve projections)")
    prev, _DEFAULT_MATMUL = _DEFAULT_MATMUL, canon
    return prev


def default_matmul_backend() -> str:
    return _DEFAULT_MATMUL


def matmul_backend_string(name: Optional[str] = None) -> str:
    """The ``cute_matmul(backend=...)`` route of a registry name
    (``None``: the process-wide default)."""
    cls = _REGISTRY[resolve(name or _DEFAULT_MATMUL)]
    s = getattr(cls, "matmul_string", None)
    if s is None:
        raise ValueError(f"backend {cls.name!r} has no cute_matmul route")
    return s
