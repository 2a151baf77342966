#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each printing one JSON line:

1. device  — require CUDA, print the card's name and power limit, turn
             TF32 off;
2. build   — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernels — every kernel of the serving path against its plain version,
             at the path's shapes plus ragged, int8, fp32/fp16 and
             masking cases, with the reference test suite's tolerances;
4. parity  — yi-6b at full width, 4 layers, fp32: prefill and 4 decode
             steps through the kernels against the plain torch route;
5. serve   — yi-6b at full width and depth, bf16, seeded random weights:
             8 requests through ``ServingEngine`` with launch counts;
6. the ``kernels`` line: per kernel, its launches in phase 5, its time at
   the path's largest shape beside its plain version, a library call and
   its roofline bound.

The last line is ``{"ok": true, "device": {...}}``.  Any failed phase
exits non-zero before it.  Without CUDA, or outside a checkout, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ARCH = "yi-6b"
N_REQUESTS, MAX_BATCH, CACHE_LEN, MAX_NEW = 8, 4, 512, 16
PROMPT_RANGE = (16, 256)            # inclusive, drawn with numpy seed 0
PARITY_LAYERS, PARITY_DECODE = 4, 4
TOL_BF16, TOL_FP32, TOL_FLASH_BF16, TOL_FLASH_FP32 = 3e-2, 1e-5, 4e-2, 1e-3
TOL_PATH = 1e-4


class PhaseFailed(Exception):
    pass


_T0 = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def rel_err(out, ref):
    """(max |out - ref| / max |ref|, max |out - ref|) in float64."""
    o, r = out.double(), ref.double()
    diff = (o - r).abs().max().item() if o.numel() else 0.0
    scale = r.abs().max().item() if r.numel() else 0.0
    return diff / (scale + 1e-30), diff


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


# ---------------------------------------------------------------------------
# Phase 1: device.
# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA card")
    from repro_torch.core.precision import disable_tf32
    disable_tf32()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(line, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "count": torch.cuda.device_count(), "nvidia_smi": line,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32": [torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32]})
    require(torch.cuda.get_device_capability(0) == (9, 0),
            "the kernels are built for sm_90a (Hopper)")
    return line


# ---------------------------------------------------------------------------
# Phase 2: build.
# ---------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    for stem in libs:
        build.load(stem)
    seconds = time.perf_counter() - t0
    ptxas = {}
    for stem, path in libs.items():
        log = Path(str(path) + ".log")
        if log.exists():
            ptxas[stem] = [ln.strip() for ln in log.read_text().splitlines()
                           if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": seconds,
          "libraries": {k: str(v.relative_to(ROOT)) for k, v in libs.items()},
          "ptxas": ptxas})


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions.
# ---------------------------------------------------------------------------

def prompt_lengths():
    rng = np.random.default_rng(0)
    return rng.integers(PROMPT_RANGE[0], PROMPT_RANGE[1] + 1, N_REQUESTS), rng


def padded_lengths(lengths):
    return [int(max(lengths[i:i + MAX_BATCH]))
            for i in range(0, len(lengths), MAX_BATCH)]


def _rand(gen, shape, dtype, device="cuda"):
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=gen,
                             dtype=torch.int8, device=device)
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def matmul_case(gen, m, k, n, dtype, *, glu=False, act="none", bias=None,
                scale_a=False, scale_b=False, residual=False, softcap=0.0,
                out_dtype=None):
    """Inputs and epilogue for one K1 case, all on the card."""
    from repro_torch.core.fusion import Epilogue, EpilogueOperands
    from repro_torch.core.task import BiasType
    a = _rand(gen, (m, k), dtype)
    # scale B like a weight so bf16 outputs stay O(1)
    b = _rand(gen, (k, n), dtype)
    if dtype.is_floating_point:
        b = (b.float() / k ** 0.5).to(dtype)
    n_out = n // 2 if glu else n
    ops = EpilogueOperands(
        bias=(None if bias is None else
              _rand(gen, (n,) if bias == "row" else (m, n), torch.float32)),
        scale_a=_rand(gen, (m,), torch.float32).abs() if scale_a else None,
        scale_b=_rand(gen, (n,), torch.float32).abs() if scale_b else None,
        residual=_rand(gen, (m, n_out), torch.float32) if residual else None)
    ep = Epilogue(bias_type={None: BiasType.ZERO, "row": BiasType.ROW,
                             "full": BiasType.FULL}[bias],
                  activation=act, glu=glu, softcap=softcap,
                  has_scale_a=scale_a, has_scale_b=scale_b,
                  has_residual=residual,
                  out_dtype=out_dtype or (torch.float32 if dtype ==
                                          torch.int8 else dtype))
    return a, b, ep, ops


def run_matmul(a, b, ep, ops):
    from repro_torch.kernels.matmul.ops import fused_matmul
    return fused_matmul(a, b, epilogue=ep, operands=ops)


def plain_matmul(a, b, ep, ops):
    from repro_torch.kernels.matmul.matmul import fused_matmul_plain
    acc = torch.int32 if a.dtype == torch.int8 else torch.float32
    return fused_matmul_plain(a, b, ep, ops, acc)


def attention_case(gen, b, h, hkv, sq, sk, d, dtype):
    return (_rand(gen, (b, h, sq, d), dtype),
            _rand(gen, (b, hkv, sk, d), dtype),
            _rand(gen, (b, hkv, sk, d), dtype))


def run_attention(q, k, v, **kw):
    from repro_torch.kernels.attention.ops import flash_attention
    return flash_attention(q, k, v, **kw)


def plain_attention(q, k, v, **kw):
    from repro_torch.kernels.attention.attention import flash_attention_plain
    return flash_attention_plain(q, k, v, **kw)


def phase_kernels(cfg, s_max):
    gen = torch.Generator(device="cuda").manual_seed(1)
    d, ff, vocab = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    results = []

    def check_mm(name, tol, **case):
        a, b, ep, ops = matmul_case(gen, **case)
        out = run_matmul(a, b, ep, ops)
        ref = plain_matmul(a, b, ep, ops)
        torch.cuda.synchronize()
        rel, diff = rel_err(out, ref)
        ok = (out.dtype == ref.dtype and out.shape == ref.shape
              and rel <= tol and bool(torch.isfinite(out.double()).all()))
        results.append({"kernel": "fused_matmul", "case": name, "rel": rel,
                        "max_abs_err": diff, "tol": tol, "ok": ok})

    bf16 = torch.bfloat16
    for m in (4 * s_max, MAX_BATCH):               # prefill, decode rows
        for tag, k, n, kw in (("wq", d, cfg.q_dim, {}),
                              ("wk", d, cfg.kv_dim, {}),
                              ("wi", d, 2 * ff, dict(glu=True, act="silu")),
                              ("wo", cfg.q_dim, d, {}),
                              ("mlp_wo", ff, d, {})):
            check_mm(f"{tag} m={m}", TOL_BF16, m=m, k=k, n=n, dtype=bf16,
                     **kw)
    check_mm("logits m=4 fp32-out", TOL_BF16, m=MAX_BATCH, k=d, n=vocab,
             dtype=bf16, out_dtype=torch.float32)
    check_mm("ragged 5x72x200 all-epilogue bf16", TOL_BF16, m=5, k=72,
             n=200, dtype=bf16, glu=True, act="gelu", bias="row",
             scale_a=True, scale_b=True, residual=True, softcap=30.0)
    check_mm("ragged 5x72x200 fp32", TOL_FP32, m=5, k=72, n=200,
             dtype=torch.float32, bias="full", act="tanh", residual=True)
    check_mm("fp32 130x257x300 relu2", TOL_FP32, m=130, k=257, n=300,
             dtype=torch.float32, act="relu2", bias="row")
    check_mm("fp16 200x512x384 glu", TOL_BF16, m=200, k=512, n=384,
             dtype=torch.float16, glu=True, act="gelu_tanh", scale_b=True)
    check_mm("int8 exact 64x4096x256", 0.0, m=64, k=4096, n=256,
             dtype=torch.int8, out_dtype=torch.int32)
    check_mm("int8 exact 3x100x70", 0.0, m=3, k=100, n=70,
             dtype=torch.int8, out_dtype=torch.int32)
    check_mm("int8 scale_a scale_b row-bias 37x200x300", TOL_FP32, m=37,
             k=200, n=300, dtype=torch.int8, bias="row", scale_a=True,
             scale_b=True, act="sigmoid")

    def check_attn(name, tol, shape, dtype, zero_rows=None, **kw):
        q, k, v = attention_case(gen, *shape, dtype)
        kw = dict(sm_scale=shape[-1] ** -0.5, window=0, softcap=0.0,
                  q_start=0) | kw
        out = run_attention(q, k, v, **kw)
        ref = plain_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        rel, diff = rel_err(out, ref)
        ok = (out.dtype == ref.dtype and out.shape == ref.shape
              and rel <= tol and bool(torch.isfinite(out.double()).all()))
        if zero_rows is not None:
            ok = ok and bool((out[:, :, zero_rows] == 0).all())
        results.append({"kernel": "flash_attention", "case": name,
                        "rel": rel, "max_abs_err": diff, "tol": tol,
                        "ok": ok})

    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    check_attn(f"path b=4 s={s_max} bf16", TOL_FLASH_BF16,
               (MAX_BATCH, h, hkv, s_max, s_max, hd), bf16, causal=True)
    check_attn("fp32 window+softcap+q_start, Sq<Sk", TOL_FLASH_FP32,
               (2, 8, 2, 50, 300, hd), torch.float32, causal=True,
               window=64, softcap=50.0, q_start=200)
    check_attn("bf16 non-causal ragged d=64", TOL_FLASH_BF16,
               (1, 4, 4, 70, 33, 64), bf16, causal=False)
    # queries at 100..119 with a window of 4 see none of the 40 keys
    check_attn("fully masked rows are 0", TOL_FLASH_FP32,
               (1, 4, 1, 20, 40, hd), torch.float32, zero_rows=slice(0, 20),
               causal=True, window=4, q_start=100)
    emit({"phase": "kernels", "cases": results})
    require(all(r["ok"] for r in results),
            "kernel mismatch: " + ", ".join(r["case"] for r in results
                                           if not r["ok"]))
    return results


# ---------------------------------------------------------------------------
# Phase 4: 4-layer fp32 full width, kernel route against the torch route.
# ---------------------------------------------------------------------------

def phase_parity():
    from repro_torch import backend
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as tf
    cfg = get_config(ARCH).with_(n_layers=PARITY_LAYERS, dtype=torch.float32,
                                 kv_cache_dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(2)
    params = tf.init(cfg, gen, "cuda")
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 64))).cuda()

    def run(route):
        prev = backend.set_default_matmul_backend(route)
        try:
            rcfg = cfg.with_(backend=route)
            cache = tf.init_cache(rcfg, 4, 64 + PARITY_DECODE + 1,
                                  device="cuda")
            logits, cache = tf.prefill(rcfg, params, {"tokens": tokens},
                                       cache)
            steps = [logits]
            for i in range(PARITY_DECODE):
                tok = forced[i] if forced else steps[-1].argmax(-1)
                logits, cache = tf.decode_step(rcfg, params, tok[:, None],
                                               cache, 64 + i)
                steps.append(logits)
            torch.cuda.synchronize()
            return steps
        finally:
            backend.set_default_matmul_backend(prev)

    forced = []
    kern = run("kernel")
    forced.extend(s.argmax(-1) for s in kern[:-1])
    plain = run("torch")
    errs = [rel_err(k, p)[0] for k, p in zip(kern, plain)]
    same = [bool(torch.equal(k.argmax(-1), p.argmax(-1)))
            for k, p in zip(kern, plain)]
    finite = all(bool(torch.isfinite(k).all()) for k in kern)
    emit({"phase": "parity", "config": f"{ARCH} width, {PARITY_LAYERS} "
          "layers, fp32", "rel_err": errs, "tol": TOL_PATH,
          "tokens_equal": same, "finite": finite})
    require(finite and all(e <= TOL_PATH for e in errs) and all(same),
            "kernel route disagrees with the torch route")
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 5: serve full-width, full-depth yi-6b through the kernels.
# ---------------------------------------------------------------------------

def phase_serve():
    from repro_torch import backend
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.kernels.matmul.ops import fused_matmul
    from repro_torch.models.base import family_module
    from repro_torch.serving.engine import ServingEngine

    require(backend.default_matmul_backend() == "kernel",
            "the default matmul route is not the kernel")
    cfg = get_config(ARCH)
    require(cfg.backend == "kernel" and cfg.dtype == torch.bfloat16,
            "yi-6b does not default to the kernel route in bf16")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = family_module(cfg).init(cfg, gen, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in _leaves(params))

    lengths, rng = prompt_lengths()
    eng = ServingEngine(cfg, params, max_batch=MAX_BATCH,
                        cache_len=CACHE_LEN)
    for n in lengths:
        eng.submit(torch.from_numpy(rng.integers(0, cfg.vocab_size, n)))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    fused_matmul.launches = 0
    flash_attention.launches = 0
    t0 = time.perf_counter()
    outs = eng.run(max_new_tokens=MAX_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fused_matmul": fused_matmul.launches,
                "flash_attention": flash_attention.launches}
    batches = [{"padded_prompt": int(max(lengths[i * MAX_BATCH:
                                                 (i + 1) * MAX_BATCH])),
                "prefill_ms": r.prefill_ms(),
                "decode_step_ms": r.decode_step_ms()}
               for i, r in enumerate(eng.results)]
    tokens = sum(int(o.numel()) for o in outs)
    ok_tokens = (len(outs) == N_REQUESTS
                 and all(o.shape == (MAX_NEW,) for o in outs)
                 and bool(((torch.stack(outs) >= 0)
                           & (torch.stack(outs) < cfg.padded_vocab)).all()))
    finite = all(bool(torch.isfinite(r.logits_last).all())
                 for r in eng.results)
    emit({"phase": "serve", "config": f"{ARCH} full width and depth "
          f"({cfg.n_layers} layers), bf16, seeded random weights",
          "params": n_params, "init_s": init_s,
          "prompt_lengths": [int(x) for x in lengths],
          "max_new_tokens": MAX_NEW, "batches": batches,
          "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": launches, "tokens_ok": ok_tokens,
          "logits_finite": finite,
          "first_request": outs[0].tolist()})
    require(ok_tokens and finite, "serving produced malformed output")
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the path never launched: {launches}")
    del params, eng
    torch.cuda.empty_cache()
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# Phase 6: times at the path's largest shapes.
# ---------------------------------------------------------------------------

def time_ms(fns: dict, reps: int = 10, warmup: int = 2) -> dict:
    """Median CUDA-event time of each callable, called in turns
    (a, b, c, c, b, a, ...)."""
    for f in fns.values():
        for _ in range(warmup):
            f()
    torch.cuda.synchronize()
    names = list(fns)
    samples = {n: [] for n in names}
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    for r in range(reps):
        for n in (names if r % 2 == 0 else names[::-1]):
            start.record()
            fns[n]()
            end.record()
            end.synchronize()
            samples[n].append(start.elapsed_time(end))
    return {n: statistics.median(v) for n, v in samples.items()}


def bound(flops: float, nbytes: float, peak: float, bw: float):
    t_ops, t_bytes = flops / peak, nbytes / bw
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_timing(cfg, s_max, launches):
    import torch.nn.functional as F
    from repro_torch.core.hardware import H100_SXM as chip
    gen = torch.Generator(device="cuda").manual_seed(4)
    kernels = []

    # K1 at its largest path shape: the prefill GLU MLP input projection.
    m, k, n = MAX_BATCH * s_max, cfg.d_model, 2 * cfg.d_ff
    a, b, ep, ops = matmul_case(gen, m, k, n, torch.bfloat16, glu=True,
                                act="silu")
    t = time_ms({"kernel": lambda: run_matmul(a, b, ep, ops),
                 "plain": lambda: plain_matmul(a, b, ep, ops),
                 "library": lambda: torch.matmul(a, b)})
    _, diff = rel_err(run_matmul(a, b, ep, ops), plain_matmul(a, b, ep, ops))
    ms, by = bound(2.0 * m * n * k, 2.0 * (m * k + k * n + m * n // 2),
                   chip.peak_bf16, chip.hbm_bw)
    kernels.append({
        "name": "fused_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_matmul.cu",
        "replaces": "src/repro/kernels/matmul/matmul.py:39",
        "launches": launches["fused_matmul"], "max_abs_err": diff,
        "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": ms,
        "bound_by": by, "library_ms": t["library"],
        "shape": f"bf16 ({m},{k})@({k},{n}) GLU-silu -> ({m},{n // 2})",
        "library_call": "torch.matmul (no epilogue)"})

    # K2 at its path shape: prefill attention of the longest batch.
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, kk, v = attention_case(gen, MAX_BATCH, h, hkv, s_max, s_max, hd,
                              torch.bfloat16)
    k_rep, v_rep = (x.repeat_interleave(h // hkv, dim=1) for x in (kk, v))
    kw = dict(sm_scale=hd ** -0.5, causal=True, window=0, softcap=0.0,
              q_start=0)
    t = time_ms({
        "kernel": lambda: run_attention(q, kk, v, **kw),
        "plain": lambda: plain_attention(q, kk, v, **kw),
        "library": lambda: F.scaled_dot_product_attention(
            q, k_rep, v_rep, is_causal=True, scale=hd ** -0.5)})
    _, diff = rel_err(run_attention(q, kk, v, **kw),
                      plain_attention(q, kk, v, **kw))
    pairs = s_max * (s_max + 1) // 2                   # causal (q, k) pairs
    ms, by = bound(4.0 * MAX_BATCH * h * pairs * hd,
                   2.0 * (2 * q.numel() + kk.numel() + v.numel()),
                   chip.peak_bf16, chip.hbm_bw)
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/attention/attention.py:34",
        "launches": launches["flash_attention"], "max_abs_err": diff,
        "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": ms,
        "bound_by": by, "library_ms": t["library"],
        "shape": f"bf16 q ({MAX_BATCH},{h},{s_max},{hd}) kv "
                 f"({MAX_BATCH},{hkv},{s_max},{hd}) causal",
        "library_call": "F.scaled_dot_product_attention on KV heads "
                        "repeated to H beforehand"})
    return kernels


def main() -> int:
    phase_device()
    from repro_torch.configs.registry import get_config
    cfg = get_config(ARCH)
    s_max = max(padded_lengths(prompt_lengths()[0]))
    try:
        phase_build()
        phase_kernels(cfg, s_max)
        phase_parity()
        launches = phase_serve()
        kernels = phase_timing(cfg, s_max, launches)
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
