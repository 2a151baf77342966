"""Serving: batched generation through the port's kernels, and the
planning half — batching policies (``scheduler``), the paged KV residency
model (``kvcache``), arrival sources (``arrivals``) and the online
admission loop (``online``)."""
