"""Optimisers: AdamW with fp32 master weights (``adamw``) and int8
error-feedback gradient compression (``compression``)."""
