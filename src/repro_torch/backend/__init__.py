"""``repro_torch.backend`` — execution engines behind one contract.

One :class:`~repro_torch.backend.base.Backend` protocol —
``dispatch(task, operands) -> handle``, ``check(handle)``,
``wait(handle)``, ``run_graph(TaskGraph)`` — with first-class
granularity (``tile | panel | layer``), epilogue fusion and a cluster
``units`` dimension, and five registered implementations:

=========================  =================================================
``get("kernel")``          the hand-written CUDA fused matmul (K1), one
                           launch per matrix tile of the graph (the
                           reference's ``pallas``)
``get("torch")``           ``torch.matmul`` + the epilogue as tensor ops
                           (the reference's ``jax``)
``get("desim")``           the discrete-event machine model — per-resource
                           timelines in simulated cycles of the paper's CPU
                           matrix unit — and, given operands, the numbers
                           from executing the *same* graph on the default
                           route
``get("analytical")``      ``core.simulator`` closed forms, contention-
                           aware at ``units=N`` — cycles only
``get("desim-cluster")``   N matrix units behind one shared, bandwidth-
                           partitioned loader (``sim.partition`` shards
                           the graph) — contended per-unit timelines, and
                           given operands the partitioned graph executed
                           on the default route
=========================  =================================================

The registry also holds the model zoo's matmul route
(``set_default_matmul_backend``; ``"kernel"`` by default) and the tuned
capability dispatch (``get_tuned``, ``tuned_config``): explicit argument
> the platform's tuning cache (``repro_torch.tune``) > untuned default.
The reference's ``sharded`` backend (``shard_map`` over a mesh) is not
ported yet.

Typical use::

    from repro_torch import backend
    from repro_torch.core.task import MatMulTask

    b = backend.get("desim", granularity="panel")
    h = b.dispatch(MatMulTask(m=512, n=512, k=4096))      # asyncMatMul
    r = b.wait(h)                                         # checkMatmul
    r.cycles, r.timeline                                  # DES payload
"""

from repro_torch.backend.base import (Backend, DispatchHandle, ExecResult,
                                      MatMulOperands, NO_MATMUL_OPERANDS)
from repro_torch.backend.registry import (ALIASES, available,
                                          default_matmul_backend,
                                          dispatch_platform, get, get_tuned,
                                          matmul_backend_string, register,
                                          resolve,
                                          set_default_matmul_backend,
                                          set_dispatch_platform,
                                          set_tuned_dispatch, tuned_config,
                                          tuned_dispatch_enabled)

# Importing the implementation modules registers them.
from repro_torch.backend.eager import KernelBackend, TorchBackend
from repro_torch.backend.desim_backend import DESimBackend
from repro_torch.backend.analytical_backend import AnalyticalBackend
from repro_torch.backend.cluster_backend import ClusterDESimBackend

__all__ = [
    "Backend", "DispatchHandle", "ExecResult", "MatMulOperands",
    "NO_MATMUL_OPERANDS",
    "ALIASES", "available", "default_matmul_backend", "dispatch_platform",
    "get", "get_tuned", "matmul_backend_string", "register", "resolve",
    "set_default_matmul_backend", "set_dispatch_platform",
    "set_tuned_dispatch", "tuned_config", "tuned_dispatch_enabled",
    "KernelBackend", "TorchBackend", "DESimBackend", "AnalyticalBackend",
    "ClusterDESimBackend",
]
