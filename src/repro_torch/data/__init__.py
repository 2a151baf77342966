"""Data: the deterministic synthetic token stream (``pipeline``)."""
