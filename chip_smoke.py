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
                reference test suite's tolerances (K3 bit for bit);
4. parity     — yi-6b at full width, 4 layers, fp32: prefill and 4 decode
                steps through the kernels against the plain torch route;
5. moe-parity — the same for olmoe-1b-7b, with the count of (token,
                layer) expert choices that differ between the routes;
6. serve      — yi-6b at full width and depth, bf16, seeded random
                weights: 8 requests through ``ServingEngine`` with launch
                counts;
7. moe-serve  — the same traffic through olmoe-1b-7b at full width and
                depth (the grouped-matmul kernel on every expert MLP);
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
                served model (``torch.profiler``), the device's idle share
                of a decode step, and for tied embeddings the time of the
                transposed copy the logits take; measurement only;
12. w8a8       — yi-6b's MLP at full width through ``quantize_mlp`` and
                the W8A8 layers (row-quantiser kernel, int8 fused matmul)
                against the plain route and the float MLP;
13. the ``kernels`` line: per kernel, its launches in the paths above, its
   time at the paths' largest shapes beside its plain version, a library
   call and its roofline bound.

Each path's launch counts are set to 0 just before it runs and read just
after.  The last line is ``{"ok": true, "device": {...}}``.  Any failed
phase exits non-zero before it.  Without CUDA, or outside a checkout, it
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
TOL_W8A8_ROUTES, TOL_W8A8_FLOAT = 1e-5, 0.05
PROFILE_STEPS, UNTRACED_STEPS = 4, 16
# a substring of each kernel's name in a profiler trace
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


def run_grouped(x, w, ep):
    from repro_torch.kernels.moe.ops import grouped_matmul
    return grouped_matmul(x, w, epilogue=ep)


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


def phase_kernels(cfg, moe_cfg, s_max):
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
    def check_gm(name, tol, *shape, **kw):
        x, w, ep = grouped_case(gen, *shape, **kw)
        out = run_grouped(x, w, ep)
        ref = plain_grouped(x, w, ep)
        torch.cuda.synchronize()
        rel, diff = rel_err(out, ref)
        ok = (out.dtype == ref.dtype and out.shape == ref.shape
              and rel <= tol and bool(torch.isfinite(out.double()).all()))
        results.append({"kernel": "grouped_matmul", "case": name,
                        "rel": rel, "max_abs_err": diff, "tol": tol,
                        "ok": ok})

    e, dm, fe = moe_cfg.moe.n_experts, moe_cfg.d_model, \
        moe_cfg.moe.d_ff_expert
    for c in (144, 64, 8):          # capacity at T = 884, 360 and decode
        check_gm(f"wi GLU-silu ({e},{c},{dm})@({e},{dm},{2 * fe})",
                 TOL_BF16, e, c, dm, 2 * fe, bf16, glu=True, act="silu")
        check_gm(f"wo ({e},{c},{fe})@({e},{fe},{dm})", TOL_BF16, e, c, fe,
                 dm, bf16)
    check_gm("ragged fp32 (5,33,72)@(5,72,200) GLU-gelu", TOL_FP32, 5, 33,
             72, 200, torch.float32, glu=True, act="gelu")
    check_gm("int8 exact (8,40,256)@(8,256,96)", 0.0, 8, 40, 256, 96,
             torch.int8)
    check_gm("int8 exact decode (4,8,100,70)", 0.0, 4, 8, 100, 70,
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

def phase_parity(arch, phase, n_layers=PARITY_LAYERS):
    from repro_torch import backend
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.base import family_module
    cfg = get_config(arch).with_(n_layers=n_layers, dtype=torch.float32,
                                 kv_cache_dtype=torch.float32)
    mod = family_module(cfg)
    gen = torch.Generator(device="cuda").manual_seed(2)
    params = mod.init(cfg, gen, "cuda")
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 64))).cuda()
    picks = {}                  # route -> each router call's expert sets

    def run(route):
        inner = moe_lib.route

        def recording(rcfg, x2d, w_router):
            gate, idx = inner(rcfg, x2d, w_router)
            picks.setdefault(route, []).append(idx.sort(dim=-1).values)
            return gate, idx
        prev = backend.set_default_matmul_backend(route)
        moe_lib.route = recording
        try:
            rcfg = cfg.with_(backend=route)
            cache = mod.init_cache(rcfg, 4, 64 + PARITY_DECODE + 1,
                                   device="cuda")
            logits, cache = mod.prefill(rcfg, params, {"tokens": tokens},
                                        cache)
            steps = [logits]
            for i in range(PARITY_DECODE):
                tok = forced[i] if forced else steps[-1].argmax(-1)
                logits, cache = mod.decode_step(rcfg, params, tok[:, None],
                                                cache, 64 + i)
                steps.append(logits)
            torch.cuda.synchronize()
            return steps
        finally:
            backend.set_default_matmul_backend(prev)
            moe_lib.route = inner

    forced = []
    kern = run("kernel")
    forced.extend(s.argmax(-1) for s in kern[:-1])
    plain = run("torch")
    errs = [rel_err(k, p)[0] for k, p in zip(kern, plain)]
    same = [bool(torch.equal(k.argmax(-1), p.argmax(-1)))
            for k, p in zip(kern, plain)]
    finite = all(bool(torch.isfinite(k).all()) for k in kern)
    line = {"phase": phase, "config": f"{arch} width, {n_layers} "
            "layers, fp32", "rel_err": errs, "tol": TOL_PATH,
            "tokens_equal": same, "finite": finite}
    if cfg.moe is not None:
        pairs = list(zip(picks["kernel"], picks["torch"]))
        line["expert_choices"] = sum(a.shape[0] for a, _ in pairs)
        line["expert_choices_differing"] = sum(
            int((a != b).any(-1).sum()) for a, b in pairs)
    emit(line)
    require(finite and all(e <= TOL_PATH for e in errs) and all(same),
            f"{arch}: kernel route disagrees with the torch route")
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Serving: full-width, full-depth yi-6b, olmoe-1b-7b, recurrentgemma-2b
# and rwkv6-7b through the kernels.
# ---------------------------------------------------------------------------

def phase_serve(arch, phase, counters):
    """``counters``: kernel name -> wrapper whose ``launches`` the path
    must raise above 0."""
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
    t0 = time.perf_counter()
    outs = eng.run(max_new_tokens=MAX_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
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
          "launches": launches, "tokens_ok": ok_tokens,
          "logits_finite": finite,
          "first_request": outs[0].tolist()})
    require(ok_tokens and finite, f"{arch}: serving produced malformed "
            "output")
    require(all(v > 0 for v in launches.values()),
            f"{arch}: a kernel of the path never launched: {launches}")
    del params, eng
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Where a prefill's and a decode step's device time goes (torch.profiler).
# ---------------------------------------------------------------------------

def _device_ms_by_kernel(prof, n):
    """(device kernel events, busy ms per call, ms per call by kernel
    group) of a trace of ``n`` calls."""
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in device) / 1e3 / n
    groups = dict.fromkeys([*KERNEL_TAGS, "other"], 0.0)
    for e in device:
        g = next((name for name, tag in KERNEL_TAGS.items() if tag in e.key),
                 "other")
        groups[g] += e.self_device_time_total / 1e3 / n
    return device, busy, groups


def phase_profile(arch, phase, s_max):
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
    _, prefill_busy, prefill_groups = _device_ms_by_kernel(prof, 1)
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
    device, busy, groups = _device_ms_by_kernel(prof, PROFILE_STEPS)
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:10]
    line = {"phase": phase, "config": f"{arch} full size, bf16, prefill of "
            f"({MAX_BATCH},{s_max}), then decode at batch {MAX_BATCH} from "
            f"position {s_max}", "steps": PROFILE_STEPS,
            "prefill_device_ms": prefill_busy,
            "prefill_device_ms_by_kernel": prefill_groups,
            "prefill_device_share_by_kernel": {
                g: ms / prefill_busy for g, ms in prefill_groups.items()
                if ms > 0} if prefill_busy else {},
            "decode_step_ms": step_ms, "traced_step_ms": traced_ms,
            "profiler_saw_device": bool(device),
            "device_busy_ms_per_step": busy,
            "device_idle_share": 1.0 - busy / step_ms,
            "device_ms_per_step_by_kernel": groups,
            "top_device_kernels": [
                {"name": e.key[:160], "launches_per_step":
                 e.count / PROFILE_STEPS,
                 "ms_per_step": e.self_device_time_total / 1e3
                 / PROFILE_STEPS}
                for e in top]}
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


def bound(flops: float, nbytes: float, peak: float, bw: float):
    t_ops, t_bytes = flops / peak, nbytes / bw
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_timing(cfg, moe_cfg, g_cfg, r_cfg, s_max, path_launches):
    """``path_launches``: path -> {kernel name: launches in that path}."""
    import torch.nn.functional as F
    from repro_torch.core.hardware import H100_SXM as chip
    from repro_torch.models.moe import moe_capacity
    gen = torch.Generator(device="cuda").manual_seed(4)
    kernels = []

    def counts(name):
        by_path = {path: n[name] for path, n in path_launches.items()
                   if name in n}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path}

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
        **counts("fused_matmul"), "max_abs_err": diff,
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
        **counts("flash_attention"), "max_abs_err": diff,
        "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": ms,
        "bound_by": by, "library_ms": t["library"],
        "shape": f"bf16 q ({MAX_BATCH},{h},{s_max},{hd}) kv "
                 f"({MAX_BATCH},{hkv},{s_max},{hd}) causal",
        "library_call": "F.scaled_dot_product_attention on KV heads "
                        "repeated to H beforehand"})

    # K4 at the MoE path's shapes: OLMoE's gate/up projection (the larger
    # of its two expert GEMMs) at the capacity of the 221-token prefill
    # batch and at decode, where most of its launches are.
    e, dm, fe = moe_cfg.moe.n_experts, moe_cfg.d_model, \
        moe_cfg.moe.d_ff_expert
    for tag, rows in (("prefill", MAX_BATCH * s_max), ("decode", MAX_BATCH)):
        c = moe_capacity(moe_cfg, rows)
        x, w, ep = grouped_case(gen, e, c, dm, 2 * fe, torch.bfloat16,
                                glu=True, act="silu")
        t = time_ms({"kernel": lambda: run_grouped(x, w, ep),
                     "plain": lambda: plain_grouped(x, w, ep),
                     "library": lambda: torch.bmm(x, w)})
        _, diff = rel_err(run_grouped(x, w, ep), plain_grouped(x, w, ep))
        ms, by = bound(2.0 * e * c * dm * 2 * fe,
                       2.0 * (x.numel() + w.numel() + e * c * fe),
                       chip.peak_bf16, chip.hbm_bw)
        kernels.append({
            "name": "grouped_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/grouped_matmul.cu",
            "replaces": "src/repro/kernels/moe/grouped_matmul.py:21",
            **counts("grouped_matmul"), "max_abs_err": diff,
            "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": ms,
            "bound_by": by, "library_ms": t["library"],
            "shape": f"{tag}: bf16 ({e},{c},{dm})@({e},{dm},{2 * fe}) "
                     f"GLU-silu -> ({e},{c},{fe})",
            "library_call": "torch.bmm in bf16 (no epilogue)"})

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
    try:
        phase_build()
        phase_kernels(cfg, moe_cfg, s_max)
        phase_kernels_recurrent(g_cfg, r_cfg, s_max)
        phase_parity(ARCH, "parity")
        phase_parity(MOE_ARCH, "moe-parity")
        phase_parity(GRIFFIN_ARCH, "griffin-parity", GRIFFIN_PARITY_LAYERS)
        phase_parity(RWKV_ARCH, "rwkv-parity")
        launches = {
            "serve": phase_serve(ARCH, "serve", dense),
            "moe-serve": phase_serve(MOE_ARCH, "moe-serve", {
                **dense, "grouped_matmul": grouped_matmul}),
            "griffin-serve": phase_serve(GRIFFIN_ARCH, "griffin-serve", {
                **dense, "rglru_scan": rglru_scan}),
            "rwkv-serve": phase_serve(RWKV_ARCH, "rwkv-serve", {
                "fused_matmul": fused_matmul, "rwkv6_scan": rwkv6_scan})}
        phase_profile(ARCH, "profile", s_max)
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
