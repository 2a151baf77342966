"""Versioned, byte-deterministic tuning cache.

One JSON file per platform under ``src/repro_torch/tune/cache/``,
keyed by shape bucket (``gemm|decode``, ``gemm|prefill``,
``sched|u2|decode``, …).  Each entry stores the winning
:class:`~repro_torch.tune.space.TunedConfig` (sparse — only non-default
fields) plus the analytical and DES prices that elected it, so a
reader can audit *why* a variant won without re-running the search.

Determinism is a contract: the same platform + budget re-tuned on the
same tree must write byte-identical files (``sort_keys`` JSON, floats
rounded to 3 decimals, no timestamps or hostnames).  A schema bump
(:data:`SCHEMA_VERSION`) invalidates old files — loaders treat a
mismatched version as "untuned" rather than guessing.
"""

from __future__ import annotations

import json
import pathlib
from typing import Optional

from repro_torch.tune.space import TunedConfig

SCHEMA_VERSION = 1

#: shipped caches live next to the package so an installed tree is tuned
#: out of the box; tests/CI may point elsewhere via the ``path=`` args.
CACHE_DIR = pathlib.Path(__file__).resolve().parent / "cache"


def cache_path(platform_name: str,
               cache_dir: Optional[pathlib.Path] = None) -> pathlib.Path:
    return pathlib.Path(cache_dir or CACHE_DIR) / f"{platform_name}.json"


def _round(x):
    if isinstance(x, float):
        return round(x, 3)
    if isinstance(x, dict):
        return {k: _round(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_round(v) for v in x]
    return x


def dump_cache(platform_name: str, entries: dict) -> str:
    """Serialize ``{bucket: entry}`` to the canonical byte form.

    Entries are dicts with ``config`` (sparse TunedConfig fields) and
    ``metrics`` (floats, rounded here).  Key order, float precision and
    the trailing newline are all pinned so reruns diff clean.
    """
    doc = {
        "schema_version": SCHEMA_VERSION,
        "platform": platform_name,
        "entries": _round(entries),
    }
    return json.dumps(doc, indent=2, sort_keys=True) + "\n"


def save_cache(platform_name: str, entries: dict,
               cache_dir: Optional[pathlib.Path] = None) -> pathlib.Path:
    path = cache_path(platform_name, cache_dir)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(dump_cache(platform_name, entries))
    _MEMO.pop((platform_name, str(path.parent)), None)
    return path


def load_cache(platform_name: str,
               cache_dir: Optional[pathlib.Path] = None) -> dict:
    """``{bucket: entry}`` for one platform; ``{}`` when there is no
    usable cache (missing file, unreadable JSON, or a schema mismatch —
    an old cache must degrade to "untuned", never to a crash)."""
    path = cache_path(platform_name, cache_dir)
    try:
        doc = json.loads(path.read_text())
    except (OSError, ValueError):
        return {}
    if (not isinstance(doc, dict)
            or doc.get("schema_version") != SCHEMA_VERSION):
        return {}
    entries = doc.get("entries")
    return entries if isinstance(entries, dict) else {}


_MEMO: "dict[tuple[str, str], dict]" = {}


def lookup(platform_name: str, bucket: str,
           cache_dir: Optional[pathlib.Path] = None) -> Optional[TunedConfig]:
    """The tuned config for (platform, bucket), or ``None`` when that
    pair is untuned.  Cache files are memoized per process; call
    :func:`clear_memo` after writing caches out-of-band."""
    key = (platform_name, str(pathlib.Path(cache_dir or CACHE_DIR)))
    if key not in _MEMO:
        _MEMO[key] = load_cache(platform_name, cache_dir)
    entry = _MEMO[key].get(bucket)
    if not entry or "config" not in entry:
        return None
    try:
        return TunedConfig.from_dict(entry["config"])
    except (TypeError, ValueError):
        return None


def clear_memo() -> None:
    _MEMO.clear()
