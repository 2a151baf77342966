"""``repro_torch.backend``: the executing matmul routes of the port."""

from repro_torch.backend.registry import (ROUTES, default_matmul_backend,
                                          matmul_backend_string,
                                          set_default_matmul_backend)

__all__ = ["ROUTES", "default_matmul_backend", "matmul_backend_string",
           "set_default_matmul_backend"]
