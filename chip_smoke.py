#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each printing one JSON line:

1. device     — require CUDA, print the card's name and power limit, turn
                TF32 off;
2. build      — compile the CUDA kernels from
                ``src/repro_torch/kernels/csrc``;
3. kernels    — every kernel of the serving paths against its plain
                version, at the paths' shapes plus ragged, int8,
                fp32/fp16, masking and rounding-tie cases, with the
                reference test suite's tolerances (K3 bit for bit); K1
                at every distinct call of the four served models (recorded
                from one prefill and one decode step at cut depth) at the
                prefill and decode row counts, and K4 at OLMoE's served
                capacities (C = 144, 64, 8, with and without the rows of
                a seeded routing), each on the tile that serves it
                (``launches_by_tile``);
4. parity     — yi-6b at full width, 4 layers, fp32: prefill and 4 decode
                steps through the kernels against the plain torch route;
                parity-bf16 the same in bf16, which takes K1's
                tensor-core and decode tiles through the model;
5. moe-parity — the same for olmoe-1b-7b, with the count of (token,
                layer) expert choices that differ between the routes;
                moe-parity-bf16 the same in bf16, through K1's and K4's
                tensor-core and decode tiles;
6. serve      — yi-6b at full width and depth, bf16, seeded random
                weights: 8 requests through ``ServingEngine`` with launch
                counts, K1's by tile against the counts reckoned from the
                traffic;
7. moe-serve  — the same traffic through olmoe-1b-7b at full width and
                depth (the grouped-matmul kernel on every expert MLP),
                K4's launches by tile against the counts reckoned from
                the traffic;
8. kernels-recurrent — the RG-LRU scan and the chunked RWKV-6 WKV
                against their plain versions at the serving paths'
                shapes, with initial states, ragged lengths, carried
                state and the decay limits; flash attention at head_dim
                256 (MQA 10/1, causal, window);
9. griffin-parity, rwkv-parity — the parity of phases 4-5 for
                recurrentgemma-2b (6 layers: two triples) and rwkv6-7b
                (4 layers);
10. griffin-serve, rwkv-serve — the traffic of phase 6 through
                recurrentgemma-2b (RG-LRU kernel on every recurrent block)
                and rwkv6-7b (WKV kernel on every time-mix block) at full
                width and depth;
11. profile, moe-profile, griffin-profile, rwkv-profile — device time by
                kernel of one prefill and over a few decode steps of each
                served model (``torch.profiler``), K1's by tile, the
                device's idle share of a decode step, and for tied
                embeddings the time of the transposed copy the logits
                take; K1's host time a call on each tile (yi-6b);
                measurement only;
12. w8a8       — yi-6b's MLP at full width through ``quantize_mlp`` and
                the W8A8 layers (row-quantiser kernel, int8 fused matmul)
                against the plain route and the float MLP;
13. the ``kernels`` line: per kernel, its launches in the paths above, its
   time at the paths' largest shapes beside its plain version, a library
   call and its roofline bound; K1 at prefill (tensor-core tile), decode
   and logits (decode tile), K4 at prefill (tensor-core tile), at decode
   with every row full and with a seeded routing's rows (decode tile),
   timed from CUDA-graph replays.

Each path's launch counts are set to 0 just before it runs and read just
after.  The last line is ``{"ok": true, "device": {...}}``.  Any failed
phase exits non-zero before it.  Without CUDA, or outside a checkout, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import re
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
MOE_ARCH = "olmoe-1b-7b"
GRIFFIN_ARCH = "recurrentgemma-2b"
RWKV_ARCH = "rwkv6-7b"
N_REQUESTS, MAX_BATCH, CACHE_LEN, MAX_NEW = 8, 4, 512, 16
PROMPT_RANGE = (16, 256)            # inclusive, drawn with numpy seed 0
PARITY_LAYERS, PARITY_DECODE = 4, 4
GRIFFIN_PARITY_LAYERS = 6           # two (rec, rec, attn) triples
TOL_BF16, TOL_FP32, TOL_FLASH_BF16, TOL_FLASH_FP32 = 3e-2, 1e-5, 4e-2, 1e-3
TOL_WKV_FP32 = 1e-4
TOL_PATH = 1e-4
# bf16 parity: both routes accumulate in fp32 and round each projection's
# output to bf16, so they differ by the rounding of sums taken in another
# order (an ulp of bf16, 2^-8 relative, on some elements), carried through
# the layers; greedy tokens are reported, not required, since a rounding
# can flip a near-tied argmax of random weights.  On an H100 the routes
# read 1.04e-2 to 1.14e-2 of max |logit| apart, and each 1.30e-2 to
# 1.58e-2 from the same weights in fp32: the limit is about 1.8 times the
# widest gap between the routes and above the bf16 rounding's own reach.
# OLMoE's torch route takes the kernel route's expert choices in bf16
# (``phase_parity``), so its gap is of the same kind.
TOL_PATH_BF16 = 2e-2
TOL_W8A8_ROUTES, TOL_W8A8_FLOAT = 1e-5, 0.05
PROFILE_STEPS, UNTRACED_STEPS = 4, 16
MAX_ROWS_DECODE = 8                 # K1's decode tile serves M <= 8
# a substring of each kernel's name in a profiler trace
# K1's and K4's tiles by kernel name within their launches
TILE_TAGS = {"tc": ("tc_tile_kernel",),
                "decode": ("decode_tile_kernel", "decode_reduce_kernel"),
                "simt": ("gemm_tile_kernel",)}
TILED = ("fused_matmul", "grouped_matmul")     # the kernels with tiles
KERNEL_TAGS = {"fused_matmul": "FusedMatmul",
               "grouped_matmul": "GroupedMatmul",
               "flash_attention": "flash_attention_kernel",
               "quantize_rowwise": "quantize_rowwise_kernel",
               "rglru_scan": "rglru_scan_kernel",
               "rwkv6_wkv": "rwkv6_wkv_kernel"}


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

def ptxas_report(text):
    """{kernel: "N registers, S bytes spill stores"} from nvcc's ``-Xptxas
    -v`` log; a template kernel is named by its mangled arguments, e.g.
    ``decode_tile_kernel<NS_11FusedMatmulE13__nv_bfloat16Li4ELb1>``."""
    out, name, spill = {}, None, "?"
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            t = re.search(r"([a-z_]+_kernel)I(.+?)EEv", m.group(1))
            name = f"{t.group(1)}<{t.group(2)}>" if t else m.group(1)[-60:]
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name] = f"{m.group(1)} registers, {spill} bytes spill stores"
            name = None
    return out


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
            ptxas[stem] = ptxas_report(log.read_text())
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


def grouped_case(gen, e, c, k, n, dtype, *, glu=False, act="none"):
    """Inputs and epilogue for one K4 case, all on the card."""
    from repro_torch.core.fusion import Epilogue
    x = _rand(gen, (e, c, k), dtype)
    w = _rand(gen, (e, k, n), dtype)
    if dtype.is_floating_point:
        w = (w.float() / k ** 0.5).to(dtype)
    ep = Epilogue(activation=act, glu=glu, out_dtype=(
        torch.int32 if dtype == torch.int8 else dtype))
    return x, w, ep


def run_grouped(x, w, ep, **promises):
    from repro_torch.kernels.moe.ops import grouped_matmul
    return grouped_matmul(x, w, epilogue=ep, **promises)


def routed_rows(x, tokens, top_k, seed):
    """The rows of a seeded routing of ``tokens`` tokens, each to top_k
    distinct experts, as ``moe_apply_local`` makes them: expert e's rows
    from min(count, C) on are zeroed in ``x`` (E, C, K) in place.
    Returns the promises the layer would pass (``rows``, ``max_rows``,
    ``max_experts``)."""
    e, c, _ = x.shape
    rng = np.random.default_rng(seed)
    picks = np.stack([rng.choice(e, top_k, replace=False)
                      for _ in range(tokens)])
    counts = np.minimum(np.bincount(picks.ravel(), minlength=e), c)
    for i, n in enumerate(counts):
        x[i, n:] = 0
    return dict(rows=torch.tensor(counts, dtype=torch.int32, device="cuda"),
                max_rows=min(c, tokens), max_experts=min(e, tokens * top_k))


def plain_grouped(x, w, ep):
    from repro_torch.kernels.moe.grouped_matmul import grouped_matmul_plain
    acc = torch.int32 if x.dtype == torch.int8 else torch.float32
    return grouped_matmul_plain(x, w, ep, acc)


def run_quant(x):
    from repro_torch.kernels.quant.ops import quantize_rowwise
    return quantize_rowwise(x)


def plain_quant(x):
    from repro_torch.kernels.quant.quant import quantize_rowwise_plain
    return quantize_rowwise_plain(x)


def ties_rows(gen, m, k, dtype):
    """Rows with absmax 127, so x / scale is x and every n + .5 is an
    exact rounding tie; row 1 is all zeros."""
    x = torch.randint(-254, 255, (m, k), generator=gen, device="cuda") / 2.0
    x[:, 0] = 127.0
    x[1] = 0.0
    return x.to(dtype)


def served_k1_calls(arch, n_layers):
    """Every distinct K1 call, as (k, n, glu, activation, softcap, bias,
    out dtype), that one prefill and one decode step of ``arch`` at full
    width, cut to ``n_layers`` layers, make in bf16."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.matmul import ops as mm_ops
    from repro_torch.models.base import family_module
    cfg = get_config(arch).with_(n_layers=n_layers)
    mod = family_module(cfg)
    params = mod.init(cfg, torch.Generator(device="cuda").manual_seed(8),
                      "cuda")
    calls = {}
    inner = mm_ops.fused_matmul_cuda      # the wrapper's 2-D launch

    def recording(a, b, ep, ops):
        calls[(a.shape[1], b.shape[1], ep.glu, ep.activation, ep.softcap,
               ep.bias_type.name.lower(), ep.out_dtype)] = None
        return inner(a, b, ep, ops)

    mm_ops.fused_matmul_cuda = recording
    try:
        tokens = torch.randint(0, cfg.vocab_size, (1, 16), device="cuda")
        cache = mod.init_cache(cfg, 1, 32, device="cuda")
        logits, cache = mod.prefill(cfg, params, {"tokens": tokens}, cache)
        mod.decode_step(cfg, params, logits.argmax(-1)[:, None], cache, 16)
        torch.cuda.synchronize()
    finally:
        mm_ops.fused_matmul_cuda = inner
    del params, cache
    torch.cuda.empty_cache()
    return list(calls)


def phase_kernels(cfg, moe_cfg, s_max, served):
    """``served``: arch -> its distinct K1 calls (``served_k1_calls``)."""
    from repro_torch.kernels.matmul.ops import fused_matmul
    from repro_torch.kernels.moe.ops import grouped_matmul
    gen = torch.Generator(device="cuda").manual_seed(1)
    d, ff, vocab = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    results = []

    def check_mm(name, tol, tile, **case):
        """One K1 case, which must run on ``tile``."""
        a, b, ep, ops = matmul_case(gen, **case)
        before = dict(fused_matmul.launches_by_tile)
        out = run_matmul(a, b, ep, ops)
        ran = [t for t, n in fused_matmul.launches_by_tile.items()
               if n != before[t]]
        ref = plain_matmul(a, b, ep, ops)
        torch.cuda.synchronize()
        rel, diff = rel_err(out, ref)
        ok = (out.dtype == ref.dtype and out.shape == ref.shape
              and rel <= tol and bool(torch.isfinite(out.double()).all())
              and ran == [tile])
        results.append({"kernel": "fused_matmul", "case": name, "tile": ran,
                        "rel": rel, "max_abs_err": diff, "tol": tol,
                        "ok": ok})

    bf16 = torch.bfloat16
    for m in (4 * s_max, MAX_BATCH):               # prefill, decode rows
        for tag, k, n, kw in (("wq", d, cfg.q_dim, {}),
                              ("wk", d, cfg.kv_dim, {}),
                              ("wi", d, 2 * ff, dict(glu=True, act="silu")),
                              ("wo", cfg.q_dim, d, {}),
                              ("mlp_wo", ff, d, {})):
            check_mm(f"{tag} m={m}", TOL_BF16,
                     "tc" if m > MAX_ROWS_DECODE else "decode", m=m, k=k,
                     n=n, dtype=bf16, **kw)
    check_mm("logits m=4 fp32-out", TOL_BF16, "decode", m=MAX_BATCH, k=d,
             n=vocab, dtype=bf16, out_dtype=torch.float32)
    check_mm("ragged 5x72x200 all-epilogue bf16", TOL_BF16, "decode", m=5,
             k=72, n=200, dtype=bf16, glu=True, act="gelu", bias="row",
             scale_a=True, scale_b=True, residual=True, softcap=30.0)
    check_mm("ragged 5x72x200 fp32", TOL_FP32, "decode", m=5, k=72, n=200,
             dtype=torch.float32, bias="full", act="tanh", residual=True)
    check_mm("fp32 130x257x300 relu2", TOL_FP32, "simt", m=130, k=257,
             n=300, dtype=torch.float32, act="relu2", bias="row")
    check_mm("fp16 200x512x384 glu", TOL_BF16, "tc", m=200, k=512, n=384,
             dtype=torch.float16, glu=True, act="gelu_tanh", scale_b=True)
    check_mm("int8 exact 64x4096x256", 0.0, "simt", m=64, k=4096, n=256,
             dtype=torch.int8, out_dtype=torch.int32)
    check_mm("int8 exact 3x100x70", 0.0, "decode", m=3, k=100, n=70,
             dtype=torch.int8, out_dtype=torch.int32)
    check_mm("int8 scale_a scale_b row-bias 37x200x300", TOL_FP32, "simt",
             m=37, k=200, n=300, dtype=torch.int8, bias="row", scale_a=True,
             scale_b=True, act="sigmoid")
    check_mm("tc ragged 70x1000x384 all-epilogue bf16", TOL_BF16, "tc", m=70,
             k=1000, n=384, dtype=bf16, act="gelu", bias="row",
             scale_a=True, scale_b=True, residual=True, softcap=30.0)
    check_mm("bf16 K % 8 != 0: 70x100x128", TOL_BF16, "simt", m=70, k=100,
             n=128, dtype=bf16, act="silu")
    # every served model's K1 calls at its prefill and decode rows; the
    # logits (fp32 out) run only at the decode rows, as they are served
    for arch, calls in served.items():
        for k, n, glu, act, softcap, bias, out_dt in calls:
            for m in (4 * s_max, MAX_BATCH):
                if out_dt == torch.float32 and m > MAX_ROWS_DECODE:
                    continue
                check_mm(f"{arch} ({m},{k})@({k},{n}){' GLU' * glu} {act}"
                         f"{' softcap' * bool(softcap)}"
                         f"{' bias' * (bias != 'zero')} -> {str(out_dt)[6:]}",
                         TOL_BF16, "tc" if m > MAX_ROWS_DECODE else "decode",
                         m=m, k=k, n=n, dtype=bf16, glu=glu, act=act,
                         softcap=softcap,
                         bias=None if bias == "zero" else bias,
                         out_dtype=out_dt)

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
    def check_gm(name, tol, tile, *shape, routed=None, **kw):
        """One K4 case, which must run on ``tile``; ``routed``: the tokens
        of a routing (seeded with that number) whose rows the call is
        promised."""
        x, w, ep = grouped_case(gen, *shape, **kw)
        promises = {} if routed is None else routed_rows(
            x, routed, moe_cfg.moe.top_k, routed)
        before = dict(grouped_matmul.launches_by_tile)
        out = run_grouped(x, w, ep, **promises)
        ran = [t for t, n in grouped_matmul.launches_by_tile.items()
               if n != before[t]]
        ref = plain_grouped(x, w, ep)
        torch.cuda.synchronize()
        rel, diff = rel_err(out, ref)
        ok = (out.dtype == ref.dtype and out.shape == ref.shape
              and rel <= tol and bool(torch.isfinite(out.double()).all())
              and ran == [tile])
        results.append({"kernel": "grouped_matmul", "case": name,
                        "tile": ran, "rel": rel, "max_abs_err": diff,
                        "tol": tol, "ok": ok})

    e, dm, fe = moe_cfg.moe.n_experts, moe_cfg.d_model, \
        moe_cfg.moe.d_ff_expert
    # capacity at T = 884, 360 and decode, each on the tile the rule names,
    # with every row full and with the rows of a seeded routing
    for tokens, c in ((884, 144), (360, 64), (MAX_BATCH, 8)):
        tile = "tc" if c > MAX_ROWS_DECODE else "decode"
        for routed in (None, tokens):
            tag = "" if routed is None else f" rows of {tokens} tokens"
            check_gm(f"wi GLU-silu ({e},{c},{dm})@({e},{dm},{2 * fe}){tag}",
                     TOL_BF16, tile, e, c, dm, 2 * fe, bf16, glu=True,
                     act="silu", routed=routed)
            check_gm(f"wo ({e},{c},{fe})@({e},{fe},{dm}){tag}", TOL_BF16,
                     tile, e, c, fe, dm, bf16, routed=routed)
    check_gm("ragged fp32 (5,33,72)@(5,72,200) GLU-gelu", TOL_FP32, "simt",
             5, 33, 72, 200, torch.float32, glu=True, act="gelu")
    check_gm("fp16 ragged C (3,70,520)@(3,520,384) GLU-silu", TOL_BF16, "tc",
             3, 70, 520, 384, torch.float16, glu=True, act="silu")
    check_gm("int8 exact (8,40,256)@(8,256,96)", 0.0, "simt", 8, 40, 256,
             96, torch.int8)
    check_gm("int8 exact decode (4,8,100,70)", 0.0, "decode", 4, 8, 100, 70,
             torch.int8)

    def check_q(name, x):
        q, scale = run_quant(x)
        q_ref, scale_ref = plain_quant(x)
        torch.cuda.synchronize()
        diff = max((q.int() - q_ref.int()).abs().max().item(),
                   (scale - scale_ref).abs().max().item())
        ok = bool(torch.equal(q, q_ref) and torch.equal(scale, scale_ref))
        results.append({"kernel": "quantize_rowwise", "case": name,
                        "max_abs_err": diff,
                        "q_mismatches": int((q != q_ref).sum()),
                        "tol": 0.0, "ok": ok})

    rows = MAX_BATCH * s_max
    for m, k, dt in ((rows, d, bf16), (rows, ff, bf16), (MAX_BATCH, d, bf16),
                     (rows, d, torch.float32), (rows, ff, torch.float32)):
        check_q(f"{str(dt)[6:]} ({m},{k})", (_rand(gen, (m, k),
                                                    torch.float32) * 3).to(dt))
    check_q("ragged fp32 (37,200)", _rand(gen, (37, 200), torch.float32))
    check_q("zero row and .5 ties fp32 (6,4096)",
            ties_rows(gen, 6, d, torch.float32))
    check_q("zero row and .5 ties bf16 (6,4096)", ties_rows(gen, 6, d, bf16))
    emit({"phase": "kernels", "cases": results})
    require(all(r["ok"] for r in results),
            "kernel mismatch: " + ", ".join(r["case"] for r in results
                                           if not r["ok"]))
    return results


def lru_case(gen, b, t, c, *, h0=False):
    """RG-LRU inputs as the recurrent block makes them: log_a =
    -8 softplus(lambda) sigmoid(r) with lambda in [2, 6]; fp32."""
    import torch.nn.functional as F
    lam = torch.rand(c, generator=gen, device="cuda") * 4.0 + 2.0
    gate = torch.sigmoid(_rand(gen, (b, t, c), torch.float32))
    log_a = -8.0 * F.softplus(lam) * gate
    x = _rand(gen, (b, t, c), torch.float32)
    return log_a, x, _rand(gen, (b, c), torch.float32) if h0 else None


def run_lru(log_a, x, h0=None):
    from repro_torch.kernels.rglru.ops import rglru_scan
    return rglru_scan(log_a, x, h0)


def plain_lru(log_a, x, h0=None):
    from repro_torch.kernels.rglru.rglru import rglru_scan_plain
    return rglru_scan_plain(log_a, x, h0)


def wkv_case(gen, b, h, t, c, dtype, *, s0=False, lw_value=None):
    """WKV inputs: r, k, v in ``dtype``; lw = -exp(clip(w, -8, 6)) in
    fp32 (the model's clip), or the constant ``lw_value``; u, s0 fp32."""
    shape = (b, h, t, c)
    r, k, v = (_rand(gen, shape, dtype) for _ in range(3))
    if lw_value is None:
        w = _rand(gen, shape, torch.float32) * 1.5 - 1.0
        lw = -torch.exp(torch.clamp(w, -8.0, 6.0))
    else:
        lw = torch.full(shape, lw_value, device="cuda")
    u = _rand(gen, (h, c), torch.float32) * 0.3
    state = _rand(gen, (b, h, c, c), torch.float32) * 0.3 if s0 else None
    return r, k, v, lw, u, state


def run_wkv(r, k, v, lw, u, s0=None, *, chunk):
    from repro_torch.kernels.rwkv6.ops import rwkv6_scan
    return rwkv6_scan(r, k, v, lw, u, chunk=chunk, initial_state=s0)


def plain_wkv(r, k, v, lw, u, s0=None, *, chunk):
    from repro_torch.kernels.rwkv6.rwkv6 import rwkv6_chunked
    return rwkv6_chunked(r, k, v, lw, u, chunk=chunk, initial_state=s0)


def phase_kernels_recurrent(g_cfg, r_cfg, s_max):
    """K5 and K6 at the recurrent serving paths' shapes, K2 at head_dim
    256, each against its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    results = []

    def record(kernel, name, out, ref, tol, extra_ok=True):
        torch.cuda.synchronize()
        rel, diff = rel_err(out, ref)
        ok = (out.dtype == ref.dtype and out.shape == ref.shape
              and rel <= tol and bool(torch.isfinite(out.double()).all())
              and extra_ok)
        results.append({"kernel": kernel, "case": name, "rel": rel,
                        "max_abs_err": diff, "tol": tol, "ok": ok})

    b, c = MAX_BATCH, g_cfg.rnn.d_rnn
    for name, shape, h0 in ((f"path ({b},{s_max},{c})", (b, s_max, c), False),
                            (f"path ({b},{s_max},{c}) with h0",
                             (b, s_max, c), True),
                            ("ragged (3,37,300) with h0", (3, 37, 300), True)):
        log_a, x, init = lru_case(gen, *shape, h0=h0)
        (h, h_last), (ref, ref_last) = (run_lru(log_a, x, init),
                                        plain_lru(log_a, x, init))
        record("rglru_scan", name, h, ref, TOL_FP32)
        record("rglru_scan", name + ": h_T", h_last, ref_last, TOL_FP32)
    # log_a -> 0: a -> 1 and beta -> 0, a pure integrator that keeps h0
    _, x, init = lru_case(gen, b, s_max, c, h0=True)
    log_a = torch.full_like(x, -1e-9)
    (h, h_last), (ref, _) = run_lru(log_a, x, init), plain_lru(log_a, x, init)
    record("rglru_scan", "log_a -> 0 keeps h0", h, ref, TOL_FP32,
           extra_ok=bool((h_last - init).abs().max() < 0.05))

    bf16, f32 = torch.bfloat16, torch.float32
    hh, hs = r_cfg.n_heads, r_cfg.rwkv.head_size
    path = (b, hh, s_max, hs)
    for name, shape, dt, chunk, kw in (
            (f"path {path} bf16 chunk 64 with state", path, bf16, 64,
             dict(s0=True)),
            (f"path {path} fp32 chunk 32", path, f32, 32, {}),
            ("ragged (2,8,100,64) fp32 chunk 64 with state", (2, 8, 100, 64),
             f32, 64, dict(s0=True)),
            ("lw = -exp(6) fp32 chunk 64", path, f32, 64,
             dict(lw_value=-float(np.exp(6.0)))),
            ("lw = -exp(-8) fp32 chunk 64", path, f32, 64,
             dict(lw_value=-float(np.exp(-8.0))))):
        args = wkv_case(gen, *shape, dt, **kw)
        (o, s), (ref, ref_s) = (run_wkv(*args, chunk=chunk),
                                plain_wkv(*args, chunk=chunk))
        record("rwkv6_wkv", name, o, ref,
               TOL_BF16 if dt == bf16 else TOL_WKV_FP32)
        record("rwkv6_wkv", name + ": state", s, ref_s, TOL_WKV_FP32)
    # two calls with the state carried equal one call
    r, k, v, lw, u, _ = wkv_case(gen, *path, f32)
    o, s = run_wkv(r, k, v, lw, u, chunk=64)
    cut = s_max // 2
    o1, s1 = run_wkv(*(z[:, :, :cut] for z in (r, k, v, lw)), u, chunk=64)
    o2, s2 = run_wkv(*(z[:, :, cut:] for z in (r, k, v, lw)), u, s1,
                     chunk=64)
    record("rwkv6_wkv", f"two calls ({cut} + rest) with the state carried",
           torch.cat([o1, o2], dim=2), o, TOL_WKV_FP32)
    record("rwkv6_wkv", "two calls: final state", s2, s, TOL_WKV_FP32)

    hq, hkv, hd = g_cfg.n_heads, g_cfg.n_kv_heads, g_cfg.head_dim
    for name, shape, dt, window, tol in (
            (f"path b={b} s={s_max} d={hd} MQA {hq}/{hkv} bf16",
             (b, hq, hkv, s_max, s_max, hd), bf16, g_cfg.window,
             TOL_FLASH_BF16),
            (f"d={hd} MQA fp32 window 64", (2, hq, hkv, 300, 300, hd), f32,
             64, TOL_FLASH_FP32)):
        q, kk, vv = attention_case(gen, *shape, dt)
        kw = dict(sm_scale=hd ** -0.5, causal=True, window=window,
                  softcap=0.0, q_start=0)
        record("flash_attention", name, run_attention(q, kk, vv, **kw),
               plain_attention(q, kk, vv, **kw), tol)
    emit({"phase": "kernels-recurrent", "cases": results})
    require(all(r["ok"] for r in results),
            "kernel mismatch: " + ", ".join(r["case"] for r in results
                                           if not r["ok"]))


# ---------------------------------------------------------------------------
# Parity: fp32 full width, cut in depth, kernel route against the torch
# route (yi-6b, olmoe-1b-7b, recurrentgemma-2b, rwkv6-7b).
# ---------------------------------------------------------------------------

def phase_parity(arch, phase, n_layers=PARITY_LAYERS, dtype=torch.float32,
                 tol=TOL_PATH):
    """Kernel route against torch route; in fp32 the greedy tokens must
    match too, in bf16 they are reported (see ``TOL_PATH_BF16``).  The
    torch route decodes the kernel route's greedy tokens; an MoE model in
    bf16 also routes each token to the kernel route's experts, since a
    bf16 rounding flips near-tied top-k choices and a flipped choice moves
    that token's output by far more than the tolerance (the torch route's
    own choices are still counted: ``expert_choices_differing``)."""
    from repro_torch import backend
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.base import family_module
    cfg = get_config(arch).with_(n_layers=n_layers, dtype=dtype,
                                 kv_cache_dtype=dtype)
    mod = family_module(cfg)
    gen = torch.Generator(device="cuda").manual_seed(2)
    params = mod.init(cfg, gen, "cuda")
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 64))).cuda()
    picks = {}                  # route -> each router call's expert sets
    chosen = []                 # the kernel route's (gate, index) per call
    follow = cfg.moe is not None and dtype == torch.bfloat16

    def run(route, rcfg=cfg, rparams=params):
        inner = moe_lib.route
        kernel_choice = iter(chosen)

        def recording(rcfg, x2d, w_router):
            gate, idx = inner(rcfg, x2d, w_router)
            picks.setdefault(route, []).append(idx.sort(dim=-1).values)
            if route == "kernel":
                chosen.append((gate, idx))
            elif follow:
                return next(kernel_choice)
            return gate, idx
        prev = backend.set_default_matmul_backend(route)
        moe_lib.route = recording
        try:
            rcfg = rcfg.with_(backend=route)
            cache = mod.init_cache(rcfg, 4, 64 + PARITY_DECODE + 1,
                                   device="cuda")
            logits, cache = mod.prefill(rcfg, rparams, {"tokens": tokens},
                                        cache)
            steps = [logits]
            for i in range(PARITY_DECODE):
                tok = forced[i] if forced else steps[-1].argmax(-1)
                logits, cache = mod.decode_step(rcfg, rparams, tok[:, None],
                                                cache, 64 + i)
                steps.append(logits)
            torch.cuda.synchronize()
            return steps
        finally:
            backend.set_default_matmul_backend(prev)
            moe_lib.route = inner

    from repro_torch.kernels.matmul.ops import fused_matmul
    from repro_torch.kernels.moe.ops import grouped_matmul
    tiled = {"fused_matmul": fused_matmul}
    if cfg.moe is not None:
        tiled["grouped_matmul"] = grouped_matmul
    forced = []
    for fn in tiled.values():
        fn.launches_by_tile = dict.fromkeys(fn.launches_by_tile, 0)
    kern = run("kernel")
    tiles = {name: dict(fn.launches_by_tile) for name, fn in tiled.items()}
    forced.extend(s.argmax(-1) for s in kern[:-1])
    plain = run("torch")
    errs = [rel_err(k, p)[0] for k, p in zip(kern, plain)]
    same = [bool(torch.equal(k.argmax(-1), p.argmax(-1)))
            for k, p in zip(kern, plain)]
    finite = all(bool(torch.isfinite(k).all()) for k in kern)
    line = {"phase": phase, "config": f"{arch} width, {n_layers} "
            f"layers, {str(dtype)[6:]}", "rel_err": errs, "tol": tol,
            "tokens_equal": same, "finite": finite}
    if cfg.moe is not None:
        pairs = list(zip(picks["kernel"], picks["torch"]))
        line["expert_choices"] = sum(a.shape[0] for a, _ in pairs)
        line["expert_choices_differing"] = sum(
            int((a != b).any(-1).sum()) for a, b in pairs)
        line["experts_follow_kernel_route"] = follow
    if dtype == torch.bfloat16:
        for name, by_tile in tiles.items():
            line[f"{name}_by_tile_kernel_route"] = by_tile
        # how far each bf16 route lies from the same weights run in fp32
        ref = run("torch", cfg.with_(dtype=torch.float32,
                                     kv_cache_dtype=torch.float32),
                  _to_fp32(params))
        line["rel_err_vs_fp32"] = {
            route: [rel_err(x.float(), r)[0] for x, r in zip(out, ref)]
            for route, out in (("kernel", kern), ("torch", plain))}
    emit(line)
    require(finite and all(e <= tol for e in errs)
            and (all(same) or dtype != torch.float32),
            f"{arch}: kernel route disagrees with the torch route")
    if dtype == torch.bfloat16:
        for name, by_tile in tiles.items():
            require(by_tile["tc"] > 0 and by_tile["decode"] > 0 and
                    by_tile["simt"] == 0, f"{arch} bf16: {name} ran on "
                    f"{by_tile}, not on its tensor-core and decode tiles "
                    "alone")
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Serving: full-width, full-depth yi-6b, olmoe-1b-7b, recurrentgemma-2b
# and rwkv6-7b through the kernels.
# ---------------------------------------------------------------------------

def phase_serve(arch, phase, counters, reckoned):
    """``counters``: kernel name -> wrapper whose ``launches`` the path
    must raise above 0; ``reckoned``: kernel name (K1, and K4 where the
    path has it) -> its launches by tile, reckoned from the traffic, which
    the path must match."""
    from repro_torch import backend
    from repro_torch.configs.registry import get_config
    from repro_torch.models.base import family_module
    from repro_torch.serving.engine import ServingEngine

    require(backend.default_matmul_backend() == "kernel",
            "the default matmul route is not the kernel")
    cfg = get_config(arch)
    require(cfg.backend == "kernel" and cfg.dtype == torch.bfloat16,
            f"{arch} does not default to the kernel route in bf16")
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
    for fn in counters.values():
        fn.launches = 0
    for name in reckoned:
        counters[name].launches_by_tile = dict.fromkeys(TILE_TAGS, 0)
    t0 = time.perf_counter()
    outs = eng.run(max_new_tokens=MAX_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    by_tile = {f"{name}_by_tile": dict(counters[name].launches_by_tile)
               for name in reckoned}
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
    emit({"phase": phase, "config": f"{arch} full width and depth "
          f"({cfg.n_layers} layers), bf16, seeded random weights",
          "params": n_params, "init_s": init_s,
          "prompt_lengths": [int(x) for x in lengths],
          "max_new_tokens": MAX_NEW, "batches": batches,
          "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": launches, **by_tile,
          **{f"{name}_by_tile_reckoned": n for name, n in reckoned.items()},
          "tokens_ok": ok_tokens,
          "logits_finite": finite,
          "first_request": outs[0].tolist()})
    require(ok_tokens and finite, f"{arch}: serving produced malformed "
            "output")
    require(all(v > 0 for v in launches.values()),
            f"{arch}: a kernel of the path never launched: {launches}")
    for name, n in reckoned.items():
        require(by_tile[f"{name}_by_tile"] == n, f"{arch}: {name} ran "
                f"{by_tile[f'{name}_by_tile']} by tile, reckoned {n}")
    del params, eng
    torch.cuda.empty_cache()
    return {**launches, **by_tile}


# ---------------------------------------------------------------------------
# Where a prefill's and a decode step's device time goes (torch.profiler).
# ---------------------------------------------------------------------------

def _device_ms_by_kernel(prof, n):
    """(device kernel events, busy ms per call, ms per call by kernel
    group, K1's and K4's ms per call by tile) of a trace of ``n`` calls."""
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in device) / 1e3 / n
    groups = dict.fromkeys([*KERNEL_TAGS, "other"], 0.0)
    tiles = {g: dict.fromkeys(TILE_TAGS, 0.0) for g in TILED}
    for e in device:
        g = next((name for name, tag in KERNEL_TAGS.items() if tag in e.key),
                 "other")
        groups[g] += e.self_device_time_total / 1e3 / n
        if g in tiles:
            tile = next(t for t, tags in TILE_TAGS.items()
                        if any(tag in e.key for tag in tags))
            tiles[g][tile] += e.self_device_time_total / 1e3 / n
    return device, busy, groups, tiles


def k1_host_us():
    """Host microseconds a K1 call takes on each tile, at a shape whose
    device time is a few microseconds and that ``select_tile`` sends to
    that tile (fp32 for the SIMT tile): 200 calls enqueued back to back,
    timed on the host's clock to a synchronize.  The tensor-core tile's
    figure includes encoding its two tensor maps; ``wrapper_decode`` is
    the decode call through the wrapper (``ops.fused_matmul``), which adds
    the reshapes and the operand checks."""
    from repro_torch.core.fusion import Epilogue, EpilogueOperands
    from repro_torch.kernels.matmul.matmul import fused_matmul_cuda, tile_for
    from repro_torch.kernels.matmul.ops import fused_matmul
    gen = torch.Generator(device="cuda").manual_seed(9)
    out = {}
    for tile, m, dtype in (("tc", 16, torch.bfloat16),
                           ("simt", 16, torch.float32),
                           ("decode", MAX_BATCH, torch.bfloat16)):
        a = _rand(gen, (m, 64), dtype)
        b = _rand(gen, (64, 64), dtype)
        ep, ops = Epilogue(out_dtype=dtype), EpilogueOperands()
        require(tile_for(a, b, ep) == tile,
                f"host-time case for {tile} runs on {tile_for(a, b, ep)}")
        for _ in range(20):
            fused_matmul_cuda(a, b, ep, ops)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fused_matmul_cuda(a, b, ep, ops)
        torch.cuda.synchronize()
        out[tile] = (time.perf_counter() - t0) * 1e6 / 200
    t0 = time.perf_counter()
    for _ in range(200):
        fused_matmul(a, b)                 # the wrapper on top, decode tile
    torch.cuda.synchronize()
    out["wrapper_decode"] = (time.perf_counter() - t0) * 1e6 / 200
    return out


def phase_profile(arch, phase, s_max, host_cost=False):
    """Device time by kernel of the prefill of the serving batch (4
    requests at the longest batch's prompt length) and over
    ``PROFILE_STEPS`` decode steps after it, and the device's idle share
    of an untraced step (the mean of ``UNTRACED_STEPS``).  With tied
    embeddings, the time of the transposed copy of the embedding that
    the logits take.  Measures only: it fails no run."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.registry import get_config
    from repro_torch.models.base import family_module
    cfg = get_config(arch)
    mod = family_module(cfg)
    params = mod.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                      "cuda")
    rng = np.random.default_rng(6)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (MAX_BATCH, s_max))).cuda()
    cache = mod.init_cache(cfg, MAX_BATCH, CACHE_LEN, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        logits, cache = mod.prefill(cfg, params, {"tokens": tokens}, cache)
        torch.cuda.synchronize()
    _, prefill_busy, prefill_groups, prefill_tiles = _device_ms_by_kernel(
        prof, 1)
    pos = s_max

    def steps(n):
        nonlocal logits, cache, pos
        for _ in range(n):
            logits, cache = mod.decode_step(cfg, params,
                                            logits.argmax(-1)[:, None],
                                            cache, pos)
            pos += 1
        torch.cuda.synchronize()

    steps(1)                                           # warm
    t0 = time.perf_counter()
    steps(UNTRACED_STEPS)
    step_ms = (time.perf_counter() - t0) * 1e3 / UNTRACED_STEPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps(PROFILE_STEPS)
        traced_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    device, busy, groups, tiles = _device_ms_by_kernel(prof, PROFILE_STEPS)
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:10]
    line = {"phase": phase, "config": f"{arch} full size, bf16, prefill of "
            f"({MAX_BATCH},{s_max}), then decode at batch {MAX_BATCH} from "
            f"position {s_max}", "steps": PROFILE_STEPS,
            "prefill_device_ms": prefill_busy,
            "prefill_device_ms_by_kernel": prefill_groups,
            **{f"prefill_{g}_ms_by_tile": t
               for g, t in prefill_tiles.items() if any(t.values())},
            "prefill_device_share_by_kernel": {
                g: ms / prefill_busy for g, ms in prefill_groups.items()
                if ms > 0} if prefill_busy else {},
            "decode_step_ms": step_ms, "traced_step_ms": traced_ms,
            "profiler_saw_device": bool(device),
            "device_busy_ms_per_step": busy,
            "device_idle_share": 1.0 - busy / step_ms,
            "device_ms_per_step_by_kernel": groups,
            **{f"{g}_ms_per_step_by_tile": t
               for g, t in tiles.items() if any(t.values())},
            "top_device_kernels": [
                {"name": e.key[:160], "launches_per_step":
                 e.count / PROFILE_STEPS,
                 "ms_per_step": e.self_device_time_total / 1e3
                 / PROFILE_STEPS}
                for e in top]}
    if host_cost:
        line["fused_matmul_host_us_per_call"] = k1_host_us()
    if cfg.tie_embeddings:
        emb = params["embedding"]
        line["tied_embedding_copy_ms"] = time_ms(
            {"copy": lambda: emb.T.contiguous()})["copy"]
        line["tied_embedding_copy_bytes"] = 2 * emb.numel() * \
            emb.element_size()
    emit(line)
    del params, cache
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# yi-6b's MLP at full width through the W8A8 layers.
# ---------------------------------------------------------------------------

def phase_w8a8(cfg, s_max):
    import torch.nn.functional as F
    from repro_torch.kernels.matmul.ops import fused_matmul
    from repro_torch.kernels.quant.ops import quantize_rowwise
    from repro_torch.kernels.quant.ref import quantize_rowwise_ref
    from repro_torch.serving.quantized import quantize_mlp
    d, ff, rows = cfg.d_model, cfg.d_ff, MAX_BATCH * s_max
    gen = torch.Generator(device="cuda").manual_seed(5)
    wi = torch.randn(d, 2 * ff, generator=gen, device="cuda") / d ** 0.5
    wo = torch.randn(ff, d, generator=gen, device="cuda") / ff ** 0.5
    x = torch.randn(rows, d, generator=gen, device="cuda")
    lin_in, lin_out = quantize_mlp(wi, wo, x)

    def mlp(route):
        h = lin_in(x, out_dtype=torch.float32, backend=route)
        g = F.silu(h[:, :ff]) * h[:, ff:]
        return g, lin_out(g, out_dtype=torch.float32, backend=route)

    counters = {"quantize_rowwise": quantize_rowwise,
                "fused_matmul": fused_matmul}
    for fn in counters.values():
        fn.launches = 0
    g_kern, y_kern = mlp("kernel")
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    _, y_plain = mlp("torch")
    # the int8 activations of both layers, kernel against plain, on the
    # same inputs
    acts = [x / lin_in.smooth, g_kern / lin_out.smooth]
    same = [bool(torch.equal(a, b) and torch.equal(sa, sb))
            for (a, sa), (b, sb) in ((quantize_rowwise(t),
                                      quantize_rowwise_ref(t))
                                     for t in acts)]
    h = x @ wi
    y_float = (F.silu(h[:, :ff]) * h[:, ff:]) @ wo
    torch.cuda.synchronize()
    rel_routes, diff_routes = rel_err(y_kern, y_plain)
    rel_float, _ = rel_err(y_kern, y_float)
    finite = bool(torch.isfinite(y_kern).all())
    emit({"phase": "w8a8", "config": f"{ARCH} MLP at full width: wi "
          f"({d},{2 * ff}), wo ({ff},{d}), calibrated and run on x "
          f"({rows},{d}), fp32 out", "launches": launches,
          "int8_activations_identical": same,
          "rel_err_vs_plain_route": rel_routes,
          "max_abs_err_vs_plain_route": diff_routes,
          "tol_vs_plain_route": TOL_W8A8_ROUTES,
          "rel_err_vs_float_mlp": rel_float,
          "tol_vs_float_mlp": TOL_W8A8_FLOAT, "finite": finite})
    require(finite and all(same) and rel_routes <= TOL_W8A8_ROUTES
            and rel_float <= TOL_W8A8_FLOAT,
            "the W8A8 MLP disagrees with its plain route or the float MLP")
    require(all(v > 0 for v in launches.values()),
            f"w8a8: a kernel of the path never launched: {launches}")
    del wi, wo, lin_in, lin_out
    torch.cuda.empty_cache()
    return launches


def _to_fp32(tree):
    """A copy of a parameter tree with its floating tensors in fp32."""
    if isinstance(tree, dict):
        return {k: _to_fp32(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_fp32(v) for v in tree)
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.float()
    return tree


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
# Times at the paths' largest shapes.
# ---------------------------------------------------------------------------

def time_ms(fns: dict, reps: int = 10, warmup: int = 2,
            flush=None) -> dict:
    """Median CUDA-event time of each callable, called in turns
    (a, b, c, c, b, a, ...).  ``flush``, if given, runs before each timed
    call, outside the timed window."""
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
            if flush is not None:
                flush()
            start.record()
            fns[n]()
            end.record()
            end.synchronize()
            samples[n].append(start.elapsed_time(end))
    return {n: statistics.median(v) for n, v in samples.items()}


def graph_ms(fns: dict, calls: int = 10) -> dict:
    """``time_ms`` per call of ``calls`` calls of each callable captured in
    one CUDA graph: a replay launches them back to back, so the host's
    time a call (the wrapper's checks and allocations) is out of the
    timing and what remains is the device's."""
    replays = {}
    for name, f in fns.items():
        f()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(calls):
                f()
        replays[name] = g.replay
    return {n: ms / calls for n, ms in time_ms(replays).items()}


def bound(flops: float, nbytes: float, peak: float, bw: float):
    t_ops, t_bytes = flops / peak, nbytes / bw
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_timing(cfg, moe_cfg, g_cfg, r_cfg, s_max, path_launches):
    """``path_launches``: path -> {kernel name: launches in that path}."""
    import torch.nn.functional as F
    from repro_torch.core.hardware import H100_SXM as chip
    from repro_torch.kernels.matmul.matmul import tile_for
    from repro_torch.kernels.moe.grouped_matmul import (
        tile_for as grouped_tile_for)
    from repro_torch.models.moe import moe_capacity
    gen = torch.Generator(device="cuda").manual_seed(4)
    kernels = []

    def counts(name):
        by_path = {path: n[name] for path, n in path_launches.items()
                   if name in n}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path}

    # K1 at its largest path shapes: the prefill GLU MLP input projection
    # (tensor-core tile), the same weight at the decode rows and the
    # logits at the decode rows (decode tile).  Each is timed as 10 calls
    # replayed from a CUDA graph (``graph_ms``): at decode the wrapper's
    # host time is of the order of the kernel's.  The weights (180 and
    # 524 MB) exceed the 50 MB L2, so no call finds B cached.
    k, n = cfg.d_model, 2 * cfg.d_ff
    for tag, rows, n_b, glu, out_dt in (
            ("prefill", MAX_BATCH * s_max, n, True, None),
            ("decode", MAX_BATCH, n, True, None),
            ("logits", MAX_BATCH, cfg.padded_vocab, False, torch.float32)):
        a, b, ep, ops = matmul_case(gen, rows, k, n_b, torch.bfloat16,
                                    glu=glu, act="silu" if glu else "none",
                                    out_dtype=out_dt)

        t = graph_ms({"kernel": lambda: run_matmul(a, b, ep, ops),
                      "plain": lambda: plain_matmul(a, b, ep, ops),
                      "library": lambda: torch.matmul(a, b)})
        tile = tile_for(a, b, ep)
        _, diff = rel_err(run_matmul(a, b, ep, ops),
                          plain_matmul(a, b, ep, ops))
        n_out = n_b // 2 if glu else n_b
        out_bytes = (4 if out_dt == torch.float32 else 2) * rows * n_out
        ms, by = bound(2.0 * rows * n_b * k,
                       2.0 * (rows * k + k * n_b) + out_bytes,
                       chip.peak_bf16, chip.hbm_bw)
        kernels.append({
            "name": "fused_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/" + (
                "fused_matmul_sm90.cu" if tile == "tc" else
                "decode_tile.cuh" if tile == "decode" else "gemm_tile.cuh"),
            "replaces": "src/repro/kernels/matmul/matmul.py:39",
            **counts("fused_matmul"),
            "launches_by_tile": {
                t_: sum(p_.get("fused_matmul_by_tile", {}).get(t_, 0)
                        for p_ in path_launches.values())
                for t_ in TILE_TAGS},
            "tile": tile, "max_abs_err": diff,
            "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": ms,
            "bound_by": by, "library_ms": t["library"],
            "shape": f"{tag}: bf16 ({rows},{k})@({k},{n_b})"
                     f"{' GLU-silu' if glu else ''} -> ({rows},{n_out})"
                     f"{' fp32' if out_dt == torch.float32 else ''}",
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
        **counts("flash_attention"), "max_abs_err": diff,
        "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": ms,
        "bound_by": by, "library_ms": t["library"],
        "shape": f"bf16 q ({MAX_BATCH},{h},{s_max},{hd}) kv "
                 f"({MAX_BATCH},{hkv},{s_max},{hd}) causal",
        "library_call": "F.scaled_dot_product_attention on KV heads "
                        "repeated to H beforehand"})

    # K4 at the MoE path's shapes: OLMoE's gate/up projection (the larger
    # of its two expert GEMMs) at the capacity of the 221-token prefill
    # batch (tensor-core tile) and at decode (decode tile), once with every
    # row full and once with the rows of a seeded 4-token top-8 routing, as
    # a served step passes them.  Each is timed as 10 calls replayed from
    # a CUDA graph, as K1; the weights (537 MB, 218 MB for the routed
    # experts) exceed the 50 MB L2.  The routed call's bound counts the
    # bytes of the experts that hold a row, the rows they hold and the
    # whole output, and the operations on those rows.
    e, dm, fe = moe_cfg.moe.n_experts, moe_cfg.d_model, \
        moe_cfg.moe.d_ff_expert
    for tag, tokens, routed in (("prefill", MAX_BATCH * s_max, False),
                                ("decode", MAX_BATCH, False),
                                ("decode, routed", MAX_BATCH, True)):
        c = moe_capacity(moe_cfg, tokens)
        x, w, ep = grouped_case(gen, e, c, dm, 2 * fe, torch.bfloat16,
                                glu=True, act="silu")
        promises = (routed_rows(x, tokens, moe_cfg.moe.top_k, 11) if routed
                    else {})
        fns = {"kernel": lambda: run_grouped(x, w, ep, **promises),
               "plain": lambda: plain_grouped(x, w, ep),
               "library": lambda: torch.bmm(x, w)}
        if routed:      # the same call without the split that max_experts
            fns["unsplit"] = lambda: run_grouped(   # sizes
                x, w, ep, **{**promises, "max_experts": None})
        t = graph_ms(fns)
        tile = grouped_tile_for(x, w, ep)
        _, diff = rel_err(run_grouped(x, w, ep, **promises),
                          plain_grouped(x, w, ep))
        rows = (promises["rows"].cpu() if routed
                else torch.full((e,), c, dtype=torch.int32))
        active, n_rows = int((rows > 0).sum()), int(rows.sum())
        ms, by = bound(2.0 * n_rows * dm * 2 * fe,
                       2.0 * (n_rows * dm + active * dm * 2 * fe
                              + e * c * fe),
                       chip.peak_bf16, chip.hbm_bw)
        kernels.append({
            "name": "grouped_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/" + (
                "grouped_matmul_sm90.cu" if tile == "tc" else
                "grouped_matmul.cu"),
            "replaces": "src/repro/kernels/moe/grouped_matmul.py:21",
            **counts("grouped_matmul"),
            "launches_by_tile": {
                t_: sum(p_.get("grouped_matmul_by_tile", {}).get(t_, 0)
                        for p_ in path_launches.values())
                for t_ in TILE_TAGS},
            "tile": tile, "max_abs_err": diff,
            "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": ms,
            "bound_by": by, "library_ms": t["library"],
            **({"ms_without_max_experts": t["unsplit"]} if routed else {}),
            "shape": f"{tag}: bf16 ({e},{c},{dm})@({e},{dm},{2 * fe}) "
                     f"GLU-silu -> ({e},{c},{fe})" + (
                         f", rows of a seeded {tokens}-token top-"
                         f"{moe_cfg.moe.top_k} routing: {active} experts, "
                         f"{n_rows} rows" if routed else ""),
            "library_call": "torch.bmm in bf16 on the full shape (no "
                            "epilogue)"})

    # K3 at the W8A8 path's shape: the fp32 activations of the input
    # projection, timed with a cold L2 (a 64 MB write before each call).
    rows, d = MAX_BATCH * s_max, cfg.d_model
    x = torch.randn(rows, d, generator=gen, device="cuda") * 3
    scratch = torch.empty(16 * 2 ** 20, device="cuda")
    t = time_ms({"kernel": lambda: run_quant(x),
                 "plain": lambda: plain_quant(x)},
                flush=lambda: scratch.fill_(0.0))
    (q, s), (q_ref, s_ref) = run_quant(x), plain_quant(x)
    diff = max((q.int() - q_ref.int()).abs().max().item(),
               (s - s_ref).abs().max().item())
    ms, by = bound(3.0 * x.numel(), 4.0 * x.numel() + x.numel() + 4.0 * rows,
                   chip.peak_fp32, chip.hbm_bw)
    kernels.append({
        "name": "quantize_rowwise", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quantize_rowwise.cu",
        "replaces": "src/repro/kernels/quant/quant.py:20",
        **counts("quantize_rowwise"), "max_abs_err": diff,
        "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": ms,
        "bound_by": by, "library_ms": None,
        "shape": f"fp32 ({rows},{d}) -> int8 ({rows},{d}), fp32 ({rows},)",
        "library_call": "none: no single PyTorch call computes a per-row "
                        "absmax int8 quantisation"})

    # K2 at head_dim 256: RecurrentGemma's prefill attention (MQA 10/1,
    # window 2048, longer than the prompt).
    h, hkv, hd = g_cfg.n_heads, g_cfg.n_kv_heads, g_cfg.head_dim
    q, kk, v = attention_case(gen, MAX_BATCH, h, hkv, s_max, s_max, hd,
                              torch.bfloat16)
    k_rep, v_rep = (x.repeat_interleave(h // hkv, dim=1) for x in (kk, v))
    kw = dict(sm_scale=hd ** -0.5, causal=True, window=g_cfg.window,
              softcap=0.0, q_start=0)
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
        **counts("flash_attention"), "max_abs_err": diff,
        "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": ms,
        "bound_by": by, "library_ms": t["library"],
        "shape": f"bf16 q ({MAX_BATCH},{h},{s_max},{hd}) kv "
                 f"({MAX_BATCH},{hkv},{s_max},{hd}) causal, window "
                 f"{g_cfg.window}",
        "library_call": "F.scaled_dot_product_attention on KV heads "
                        "repeated to H beforehand"})

    # K5 at RecurrentGemma's prefill shape, from a carried state (the
    # stateful pass), cold L2.  About ten operations per element: exp,
    # expm1, sqrt, three multiplies, an add and the doubling.
    b, c = MAX_BATCH, g_cfg.rnn.d_rnn
    log_a, x, h0 = lru_case(gen, b, s_max, c, h0=True)
    scratch = torch.empty(16 * 2 ** 20, device="cuda")
    t = time_ms({"kernel": lambda: run_lru(log_a, x, h0),
                 "plain": lambda: plain_lru(log_a, x, h0)},
                flush=lambda: scratch.fill_(0.0))
    _, diff = rel_err(run_lru(log_a, x, h0)[0], plain_lru(log_a, x, h0)[0])
    ms, by = bound(10.0 * x.numel(), 4.0 * (3 * x.numel() + 2 * b * c),
                   chip.peak_fp32, chip.hbm_bw)
    kernels.append({
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru/rglru.py:23",
        **counts("rglru_scan"), "max_abs_err": diff,
        "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": ms,
        "bound_by": by, "library_ms": None,
        "shape": f"fp32 log_a, x ({b},{s_max},{c}), h0 ({b},{c}) -> h, h_T",
        "library_call": "none: no single PyTorch call computes the "
                        "recurrence"})

    # K6 at RWKV-6's serving prefill shape (chunk 64, carried state, bf16
    # r, k, v), cold L2.  Operations of the chunked form on this run's
    # tokens, all in fp32 as the function defines them: per (batch, head)
    # and chunk of n tokens, the inter-chunk product and the state update
    # 2 n C^2 each, the pairwise term n(n-1)/2 pairs of C (r k, the
    # exponent's difference, exp, the sum: 5 operations) plus its 2 C
    # against V, and about 12 n C for the prefix sum, the bonus and the
    # scalings.
    hh, hs = r_cfg.n_heads, r_cfg.rwkv.head_size
    args = wkv_case(gen, b, hh, s_max, hs, torch.bfloat16, s0=True)
    t = time_ms({"kernel": lambda: run_wkv(*args, chunk=64),
                 "plain": lambda: plain_wkv(*args, chunk=64)},
                flush=lambda: scratch.fill_(0.0))
    _, diff = rel_err(run_wkv(*args, chunk=64)[0],
                      plain_wkv(*args, chunk=64)[0])
    lens = [min(64, s_max - i) for i in range(0, s_max, 64)]
    ops = b * hh * sum(4 * n * hs * hs + n * (n - 1) // 2 * hs * 7
                       + 12 * n * hs for n in lens)
    r, k, v, lw, u, s0 = args
    nbytes = (2 * 4 * r.numel()                  # r, k, v read, o written
              + 4 * (lw.numel() + u.numel() + 2 * s0.numel()))
    ms, by = bound(float(ops), float(nbytes), chip.peak_fp32, chip.hbm_bw)
    kernels.append({
        "name": "rwkv6_wkv", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6_wkv.cu",
        "replaces": "src/repro/kernels/rwkv6/rwkv6.py:32",
        **counts("rwkv6_scan"), "max_abs_err": diff,
        "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": ms,
        "bound_by": by, "library_ms": None,
        "shape": f"bf16 r, k, v ({b},{hh},{s_max},{hs}), fp32 lw, u "
                 f"({hh},{hs}), state ({b},{hh},{hs},{hs}), chunk 64",
        "library_call": "none: no single PyTorch call computes the "
                        "recurrence"})
    return kernels


def main() -> int:
    phase_device()
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.kernels.matmul.ops import fused_matmul
    from repro_torch.kernels.moe.ops import grouped_matmul
    from repro_torch.kernels.rglru.ops import rglru_scan
    from repro_torch.kernels.rwkv6.ops import rwkv6_scan
    cfg, moe_cfg = get_config(ARCH), get_config(MOE_ARCH)
    g_cfg, r_cfg = get_config(GRIFFIN_ARCH), get_config(RWKV_ARCH)
    s_max = max(padded_lengths(prompt_lengths()[0]))
    dense = {"fused_matmul": fused_matmul, "flash_attention": flash_attention}
    # K1's launches by tile in each serving path, reckoned from the traffic:
    # 2 batches (prefills at 221 and 90 tokens, each with one logits call
    # at M = 4) and 2 x 15 decode steps, each with one logits call.  Per
    # layer: yi-6b and OLMoE's attention 4 projections, yi-6b's MLP 2;
    # RecurrentGemma's recurrent blocks 5 and attention blocks 4, MLP 2 on
    # both, and its prefill runs the stack twice; RWKV-6's time mix 7 and
    # channel mix 3.
    steps = N_REQUESTS // MAX_BATCH * (MAX_NEW - 1)

    def reckon(per_pass, passes=1, logits=1):
        """``per_pass``: calls in one pass over the stack; ``logits``: K1's
        logits call after each pass (K4 has none)."""
        return {"tc": 2 * passes * per_pass,
                "decode": steps * (per_pass + logits) + 2 * logits,
                "simt": 0}
    g_attn = sum(1 for i in range(g_cfg.n_layers) if i % 3 == 2)
    k1_tiles = {
        "serve": reckon(6 * cfg.n_layers),
        "moe-serve": reckon(4 * moe_cfg.n_layers),
        "griffin-serve": reckon(7 * (g_cfg.n_layers - g_attn) + 6 * g_attn,
                                passes=2),
        "rwkv-serve": reckon(10 * r_cfg.n_layers)}
    # K4: both expert GEMMs of every OLMoE layer, the prefills' (C = 144
    # and 64) on the tensor-core tile, the decode steps' (C = 8) on the
    # decode tile: 64 tc and 960 decode launches
    k4_tiles = reckon(2 * moe_cfg.n_layers, logits=0)
    try:
        phase_build()
        served = {ARCH: served_k1_calls(ARCH, 1),
                  MOE_ARCH: served_k1_calls(MOE_ARCH, 1),
                  GRIFFIN_ARCH: served_k1_calls(GRIFFIN_ARCH, 3),
                  RWKV_ARCH: served_k1_calls(RWKV_ARCH, 1)}
        phase_kernels(cfg, moe_cfg, s_max, served)
        phase_kernels_recurrent(g_cfg, r_cfg, s_max)
        phase_parity(ARCH, "parity")
        phase_parity(MOE_ARCH, "moe-parity")
        phase_parity(GRIFFIN_ARCH, "griffin-parity", GRIFFIN_PARITY_LAYERS)
        phase_parity(RWKV_ARCH, "rwkv-parity")
        phase_parity(ARCH, "parity-bf16", dtype=torch.bfloat16,
                     tol=TOL_PATH_BF16)
        phase_parity(MOE_ARCH, "moe-parity-bf16", dtype=torch.bfloat16,
                     tol=TOL_PATH_BF16)
        launches = {
            "serve": phase_serve(ARCH, "serve", dense,
                                 {"fused_matmul": k1_tiles["serve"]}),
            "moe-serve": phase_serve(MOE_ARCH, "moe-serve", {
                **dense, "grouped_matmul": grouped_matmul},
                {"fused_matmul": k1_tiles["moe-serve"],
                 "grouped_matmul": k4_tiles}),
            "griffin-serve": phase_serve(GRIFFIN_ARCH, "griffin-serve", {
                **dense, "rglru_scan": rglru_scan},
                {"fused_matmul": k1_tiles["griffin-serve"]}),
            "rwkv-serve": phase_serve(RWKV_ARCH, "rwkv-serve", {
                "fused_matmul": fused_matmul, "rwkv6_scan": rwkv6_scan},
                {"fused_matmul": k1_tiles["rwkv-serve"]})}
        phase_profile(ARCH, "profile", s_max, host_cost=True)
        phase_profile(MOE_ARCH, "moe-profile", s_max)
        phase_profile(GRIFFIN_ARCH, "griffin-profile", s_max)
        phase_profile(RWKV_ARCH, "rwkv-profile", s_max)
        launches["w8a8"] = phase_w8a8(cfg, s_max)
        kernels = phase_timing(cfg, moe_cfg, g_cfg, r_cfg, s_max, launches)
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
