"""Batched serving example: continuous batching over the async engine
across three architecture families (KV-cache attention, O(1)-state
RWKV, and the RG-LRU hybrid).

    PYTHONPATH=src python examples/serve_batched_torch.py [--device cpu]

The PyTorch port's counterpart of ``serve_batched.py``: every projection
runs on the CUDA fused-matmul kernel, prefill attention on the flash
kernel, RWKV-6's WKV and the RG-LRU scan on theirs.  Runs on the CUDA
card; ``--device cpu`` runs the kernels' plain versions on the CPU
instead, and without a card and without ``--device`` it stops with an
error.
"""

import argparse
import os
import sys
import time
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.backend import set_default_matmul_backend
from repro_torch.configs.registry import get_config
from repro_torch.launch.serve import resolve_device
from repro_torch.models.base import family_module
from repro_torch.serving.engine import ServingEngine

ARCHS = ("yi-6b",                 # dense GQA + KV cache
         "rwkv6-7b",              # attention-free, O(1) state
         "recurrentgemma-2b")     # hybrid: RG-LRU + windowed cache


def config(arch: str, route: str = "kernel"):
    """The reduced configuration in fp32; ``route`` ``"kernel"`` (the
    CUDA kernels) or ``"torch"`` (plain tensor ops) for attention and
    the recurrences."""
    return get_config(arch, reduced=True).with_(
        dtype=torch.float32, remat="none", kv_cache_dtype=torch.float32,
        backend=route)


def init_params(cfg, device, seed=0):
    return family_module(cfg).init(
        cfg, torch.Generator(device=device).manual_seed(seed), device)


def prompts(cfg, device, n_requests: int = 5, seed=1):
    """``n_requests`` prompts of 4 + (5 i) % 10 tokens from a seeded
    generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randint(0, cfg.vocab_size, (4 + (i * 5) % 10,),
                          generator=gen, device=device)
            for i in range(n_requests)]


def serve(arch: str, params, requests, *, max_new: int = 12,
          route: str = "kernel", verbose: bool = True):
    """Serve ``requests`` with ``params`` through ``ServingEngine`` on
    ``route`` (``"kernel"`` or ``"torch"``, projections included); the
    greedy tokens, one tensor a request."""
    cfg = config(arch, route)
    prev = set_default_matmul_backend(route)
    try:
        eng = ServingEngine(cfg, params, max_batch=4, cache_len=128)
        for p in requests:
            eng.submit(p)
        t0 = time.perf_counter()
        outs = eng.run(max_new_tokens=max_new)
        total = sum(int(o.shape[0]) for o in outs)   # waits for the card
        dt = time.perf_counter() - t0
    finally:
        set_default_matmul_backend(prev)
    if verbose:
        print(f"[{arch}] {len(outs)} requests, {total} new tokens, "
              f"{dt:.2f}s ({total / dt:.1f} tok/s)")
        for i, o in enumerate(outs[:3]):
            print(f"   req{i} -> {list(map(int, o))}")
    return outs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, required)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = {}
    for arch in ARCHS:
        cfg = config(arch)
        out[arch] = serve(arch, init_params(cfg, device),
                          prompts(cfg, device))
    return out


if __name__ == "__main__":
    main()
