"""Backend registry: names -> Backend classes, the zoo's default matmul
route, and the tuned capability-dispatch layer.

``get("desim", unit=..., granularity="panel")`` is the one lookup every
front door goes through; registering a new engine is a
``@register("name")`` decoration away.  ``ALIASES`` accepts the
reference's spellings: ``"jax"`` and ``"xla"`` name the plain-ops route
``"torch"``, ``"pallas"`` the CUDA kernel route ``"kernel"``, and
``"analytic"`` the closed form ``"analytical"``.

``get_tuned`` is the capability-aware variant: it resolves the best
autotuned kernel configuration for (current platform × shape class)
from the :mod:`repro_torch.tune` cache and folds it into the constructor
kwargs.  Dispatch precedence, everywhere: **explicit argument > tuned
cache > untuned default** — passing any kwarg explicitly always wins,
and a missing/invalid cache silently degrades to the untuned defaults.
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
    global _DEFAULT_MATMUL, _MATMUL_SET_EXPLICITLY
    canon = resolve(name)
    cls = _REGISTRY[canon]
    if not cls.executes or cls.models_time:
        raise ValueError(
            f"backend {canon!r} is not an eager matmul route for the "
            "model zoo; use 'kernel' or 'torch' (modelling backends price "
            "schedules, they don't serve projections)")
    prev, _DEFAULT_MATMUL = _DEFAULT_MATMUL, canon
    _MATMUL_SET_EXPLICITLY = True
    return prev


def default_matmul_backend() -> str:
    return _DEFAULT_MATMUL


def matmul_backend_string(name: Optional[str] = None,
                          shape: "Optional[tuple]" = None) -> str:
    """The ``cute_matmul(backend=...)`` route of a registry name.

    ``name=None`` resolves the default route with tuned-dispatch
    precedence: an explicit ``set_default_matmul_backend`` setting wins;
    otherwise, when ``shape`` (``(m, n, k)``) is given and the current
    platform's tuning cache pins a route for that shape class, the tuned
    route is used; else the untuned default (``"kernel"``).  A cached
    route is spelt as in the reference's caches and maps through
    ``ALIASES`` (``"xla"`` -> ``"torch"``, ``"pallas"`` -> ``"kernel"``);
    the reference's ``"auto"`` (Pallas where the shape fits its tiling
    contract, XLA elsewhere) maps to ``"kernel"``, since the CUDA kernel
    masks ragged edges itself and takes every shape.
    """
    if name is None and shape is not None and not _MATMUL_SET_EXPLICITLY:
        cfg = tuned_config(shape=shape)
        if cfg is not None and cfg.route is not None:
            name = "kernel" if cfg.route == "auto" else cfg.route
    cls = _REGISTRY[resolve(name or _DEFAULT_MATMUL)]
    s = getattr(cls, "matmul_string", None)
    if s is None:
        raise ValueError(f"backend {cls.name!r} has no cute_matmul route")
    return s


# ---------------------------------------------------------------------------
# Tuned capability dispatch (the runtime consumer of ``repro_torch.tune``).
# ---------------------------------------------------------------------------

_DISPATCH_PLATFORM = "shuttle"       # the repo's canonical platform
_TUNED_DISPATCH = True
_MATMUL_SET_EXPLICITLY = False


def set_dispatch_platform(platform) -> str:
    """Pin the platform the tuned dispatch resolves against (a name from
    ``repro_torch.core.hardware.PLATFORMS`` or a ``CpuPlatform``).
    Returns the previous name."""
    global _DISPATCH_PLATFORM
    prev = _DISPATCH_PLATFORM
    _DISPATCH_PLATFORM = _platform_name(platform)
    return prev


def dispatch_platform() -> str:
    return _DISPATCH_PLATFORM


def set_tuned_dispatch(enabled: bool) -> bool:
    """Process-wide kill switch for the tuned cache (explicit arguments
    and untuned defaults are unaffected).  Returns the previous state."""
    global _TUNED_DISPATCH
    prev, _TUNED_DISPATCH = _TUNED_DISPATCH, bool(enabled)
    return prev


def tuned_dispatch_enabled() -> bool:
    return _TUNED_DISPATCH


def _platform_name(platform) -> str:
    from repro_torch.core.hardware import PLATFORMS
    name = getattr(platform, "name", platform)
    if name is None:
        return _DISPATCH_PLATFORM
    if name not in PLATFORMS:
        raise KeyError(f"unknown platform {name!r}; known: "
                       f"{sorted(PLATFORMS)}")
    return name


def tuned_config(*, shape=None, sched=None, bucket: Optional[str] = None,
                 platform=None):
    """The cached :class:`~repro_torch.tune.space.TunedConfig` for
    (platform × shape class), or ``None`` when untuned (no cache entry,
    dispatch disabled, or no shape class derivable).

    The shape class comes from ``bucket`` (a literal cache key),
    ``sched`` (a serving ``BatchSchedule``), or ``shape`` (an ``(m, n,
    k)`` tuple or a ``MatMulTask``), in that precedence order.
    """
    if not _TUNED_DISPATCH:
        return None
    from repro_torch import tune
    if bucket is None:
        if sched is not None:
            bucket = tune.schedule_bucket(sched)
        elif shape is not None:
            if hasattr(shape, "m"):
                shape = (shape.m, shape.n, shape.k)
            bucket = f"gemm|{tune.shape_bucket(*shape)}"
        else:
            return None
    return tune.lookup(_platform_name(platform), bucket)


def get_tuned(name: str, *, shape=None, sched=None,
              bucket: Optional[str] = None, **explicit) -> Backend:
    """Instantiate ``name`` with the best tuned configuration for the
    current platform and the given shape class.

    Explicit kwargs win over tuned ones; tuned ones win over the
    backend's untuned defaults; with no usable cache entry this is
    exactly ``get(name, **explicit)``.  Tuned kwargs a backend cannot
    accept (``k_stream`` on single-unit engines) are dropped, and a
    tuned ``overlap`` choice is applied by the serving engine (it is a
    schedule attribute, not a constructor kwarg).
    """
    cls = _REGISTRY[resolve(name)]
    cfg = tuned_config(shape=shape, sched=sched, bucket=bucket,
                       platform=explicit.get("platform"))
    kw: dict = {}
    if cfg is not None:
        from repro_torch.core.config import CASE_STUDY
        base_unit = explicit.get("unit", CASE_STUDY)
        kw = cfg.backend_kwargs(base_unit)
        if not cls.supports_units:
            kw.pop("k_stream", None)
    kw.update(explicit)
    return cls(**kw)
