"""Model-guided kernel autotuning and the per-platform tuning cache.

``space`` declares the search space (:class:`TunedConfig`, shape
buckets), ``autotune`` runs the propose/dispose loop (analytical model
ranks, DES elects), ``cache`` persists winners per platform, and
``regime`` pins the canonical Llama-style decode-regime measurement.
The runtime consumer is ``repro_torch.backend.registry.get_tuned`` —
dispatch precedence is explicit argument > tuned cache > untuned
default.  The shipped caches are byte copies of the reference's, and
the full-space autotune here regenerates them byte for byte.
"""

from repro_torch.tune.cache import (SCHEMA_VERSION, cache_path,
                                    clear_memo, dump_cache, load_cache,
                                    lookup, save_cache)
from repro_torch.tune.space import (DEFAULT_CONFIG, TunedConfig,
                                    bucket_of_task, gemm_candidates,
                                    schedule_bucket, schedule_candidates,
                                    shape_bucket)

__all__ = [
    "SCHEMA_VERSION", "cache_path", "clear_memo", "dump_cache",
    "load_cache", "lookup", "save_cache",
    "DEFAULT_CONFIG", "TunedConfig", "bucket_of_task", "gemm_candidates",
    "schedule_bucket", "schedule_candidates", "shape_bucket",
]
