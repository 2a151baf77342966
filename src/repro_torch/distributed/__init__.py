"""Distribution over ``torch.distributed``.

* ``logical``           — logical-axis rules and ``constrain``;
* ``sharding``          — parameter, batch and cache rules, their
  placement as DTensors, each rank's shards as plain tensors and their
  inverse, and the cluster-partitioned GEMM through K1;
* ``tensor_parallel``   — a rank's share of a model under a mesh: tensor
  parallelism over ``model``, FSDP and data parallelism;
* ``collective_matmul`` — an all-gather overlapped with the matmul that
  consumes it (a ring of point-to-point passes, K1 at each step);
* ``pipeline``          — GPipe over a ``pp`` axis;
* ``collectives``       — the one place the port's collectives go
  through, their autograd pairs, and the count of those staged through
  the host.

Meshes and the world come from ``launch.mesh``.
"""
