"""Serving: batched generation through the port's kernels."""
