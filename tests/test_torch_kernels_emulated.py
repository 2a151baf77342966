"""The CUDA kernels' own source, run on the CPU against their plain
versions.

A CUDA kernel has no interpret mode, so this file makes one: it compiles
``src/repro_torch/kernels/csrc/*.cu`` with the host C++ compiler against
small stand-in CUDA headers (one ``std::thread`` per CUDA thread, a
barrier for ``__syncthreads``, blocks one after another), binds the
result with ``ctypes`` exactly as the port binds the real libraries, and
drives it through the port's launch code.  It checks the kernels'
indexing, masking, tiling and epilogue logic; it cannot check timing,
the GPU memory model or what ``nvcc`` accepts (tests/
test_torch_kernels_cuda.py does that on the card).  Skips without g++.

The sources in ``build.CARD_ONLY`` are left out: the tensor-core tile of
K1 and K4 (``fused_matmul_sm90.cu``, ``grouped_matmul_sm90.cu`` on
``tc_tile.cuh``) and K2's (``flash_attention_sm90.cu``) are TMA,
mbarrier and wgmma PTX with ``CUtensorMap`` arguments, and K6's
(``rwkv6_wkv_sm90.cu``) is ``mma.sync`` PTX, none of which a CPU
stand-in can run.  So the fixture routes every call K1's, K4's, K2's or
K6's ``select_tile`` sends to ``"tc"`` to the SIMT tile instead (of the
cases below, K1's fp16 70x40x96 GLU case, K4's 16-bit cases with C > 8,
K2's 16-bit cases at head_dim 64, 128 and 256 and K6's 16-bit cases at
head size 64); the card tests hold the tensor-core tiles themselves
against the plain versions.
"""

import ctypes
import shutil
import subprocess

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.fusion import Epilogue, EpilogueOperands  # noqa: E402
from repro_torch.core.task import BiasType                   # noqa: E402
from repro_torch.kernels import build                        # noqa: E402
from repro_torch.kernels.attention import attention as attn  # noqa: E402
from repro_torch.kernels.matmul import matmul as mm          # noqa: E402
from repro_torch.kernels.moe import grouped_matmul as gm     # noqa: E402
from repro_torch.kernels.quant import quant as qr            # noqa: E402
from repro_torch.kernels.rglru import rglru as rg            # noqa: E402
from repro_torch.kernels.rwkv6 import rwkv6 as wkv           # noqa: E402

CUDA_RUNTIME_H = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <thread>
#include <vector>
using std::max; using std::min;
#define __global__
#define __device__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __shared__ static
#define __launch_bounds__(...)
#define __restrict__
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;
inline std::barrier<>* emu_bar;
inline void __syncthreads() { emu_bar->arrive_and_wait(); }
inline float emu_shfl[1024];
inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  const int t = threadIdx.x;
  emu_shfl[t] = v;
  __syncthreads();
  const float r = emu_shfl[t ^ lane_mask];
  __syncthreads();
  return r;
}
inline std::vector<float> emu_dyn(1 << 20);
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
struct uint4 { unsigned x, y, z, w; };
struct float4 { float x, y, z, w; };
struct uint2 { unsigned x, y; };
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef struct CUstream_st* cudaStream_t;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class T>
cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <class F> void emu_launch(dim3 g, dim3 b, F f) {
  gridDim = g;
  blockDim = b;
  for (unsigned z = 0; z < g.z; ++z)
    for (unsigned y = 0; y < g.y; ++y)
      for (unsigned x = 0; x < g.x; ++x) {
        std::barrier<> bar(b.x);
        emu_bar = &bar;
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < b.x; ++t)
          ts.emplace_back([&, t, x, y, z] {
            threadIdx = dim3(t); blockIdx = dim3(x, y, z); f(); });
        for (auto& th : ts) th.join();
      }
}
"""
CUDA_FP16_H = r"""
#pragma once
struct __half { _Float16 v; };
inline float __half2float(__half h) { return (float)h.v; }
inline __half __float2half_rn(float f) { return __half{(_Float16)f}; }
"""
CUDA_BF16_H = r"""
#pragma once
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { uint16_t x; };
inline float __bfloat162float(__nv_bfloat16 h) {
  uint32_t u = (uint32_t)h.x << 16; float f; std::memcpy(&f, &u, 4); return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u; std::memcpy(&u, &f, 4); u += 0x7fff + ((u >> 16) & 1);
  return __nv_bfloat16{(uint16_t)(u >> 16)};
}
"""

# cuda_fp8.h's two formats, decoded bit by bit as __nv_fp8_e4m3 and
# __nv_fp8_e5m2 decode them: e4m3fn has no infinity and its NaN is
# 0x7f / 0xff; e5m2 has IEEE infinities and NaNs; both have subnormals.
CUDA_FP8_H = r"""
#pragma once
#include <cmath>
#include <cstdint>
typedef unsigned char __nv_fp8_storage_t;
inline float emu_fp8(unsigned x, int mbits, int bias, bool fn) {
  const int e = (x & 0x7f) >> mbits, m = x & ((1 << mbits) - 1);
  const int emax = (1 << (7 - mbits)) - 1;
  float v;
  if (fn ? (e == emax && m == (1 << mbits) - 1) : (e == emax && m != 0))
    v = NAN;
  else if (!fn && e == emax)
    v = INFINITY;
  else if (e == 0)
    v = std::ldexp((float)m, 1 - bias - mbits);
  else
    v = std::ldexp((float)(m + (1 << mbits)), e - bias - mbits);
  return (x & 0x80) ? -v : v;
}
struct __nv_fp8_e4m3 {
  __nv_fp8_storage_t __x;
  explicit operator float() const { return emu_fp8(__x, 3, 7, true); }
};
struct __nv_fp8_e5m2 {
  __nv_fp8_storage_t __x;
  explicit operator float() const { return emu_fp8(__x, 2, 15, false); }
};
"""
FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def _emulable(src: str) -> str:
    """``k<<<grid, block, smem, stream>>>(args)`` becomes
    ``emu_launch(grid, block, [&] { k(args); })``; dynamic shared memory
    becomes one host buffer."""
    src = src.replace("extern __shared__ float smem[];",
                      "float* smem = emu_dyn.data();")
    while "<<<" in src:
        i = src.index("<<<")
        j = src.index(">>>", i)
        grid, block = [c.strip() for c in src[i + 3:j].split(",")][:2]
        k = i
        while src[k - 1].isspace():
            k -= 1
        if src[k - 1] == ">":                 # template arguments
            depth = 0
            while True:
                k -= 1
                depth += {">": 1, "<": -1}.get(src[k], 0)
                if depth == 0:
                    break
        while src[k - 1].isalnum() or src[k - 1] == "_":
            k -= 1
        p = src.index("(", j)
        q, depth = p, 0
        while True:
            depth += {"(": 1, ")": -1}.get(src[q], 0)
            if depth == 0:
                break
            q += 1
        src = (src[:k] + f"emu_launch({grid}, {block}, [&] {{ "
               f"{src[k:i].strip()}{src[p:q + 1]}; }})" + src[q + 1:])
    return src


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel libraries, compiled for the CPU."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile the kernels for the CPU")
    d = tmp_path_factory.mktemp("cuda_emu")
    for name, text in (("cuda_runtime.h", CUDA_RUNTIME_H),
                       ("cuda_fp16.h", CUDA_FP16_H),
                       ("cuda_bf16.h", CUDA_BF16_H),
                       ("cuda_fp8.h", CUDA_FP8_H)):
        (d / name).write_text(text)
    for header in build.CSRC.glob("*.cuh"):
        (d / header.name).write_text(_emulable(header.read_text()))
    libs = {}
    procs = []
    for src in build.sources():
        if src.stem in build.CARD_ONLY:
            continue
        cpp = d / f"{src.stem}.cpp"
        cpp.write_text(_emulable(src.read_text()))
        libs[src.stem] = d / f"lib{src.stem}.so"
        procs.append(subprocess.Popen(
            [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-I", str(d),
             "-o", str(libs[src.stem]), str(cpp), "-lpthread"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out
    return {k: ctypes.CDLL(str(v)) for k, v in libs.items()}


@pytest.fixture
def bound(emulated, monkeypatch):
    """Point the port's launchers at the emulated libraries; K1's, K4's,
    K2's and K6's calls that their ``select_tile`` sends to a card-only
    tensor-core tile run on the SIMT tile."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    mm_fn = emulated["fused_matmul"].fused_matmul_launch
    mm_fn.argtypes = [i, p, p, p, i, i, i, i, i, i, i, p, p, p, p, f, i, i,
                      i, p]
    dec_fn = emulated["fused_matmul"].fused_matmul_decode_launch
    dec_fn.argtypes = [i, p, p, p, i, i, i, i, i, i, i, p, i, p, p, p, p, f,
                       i, i, i, p]
    fa_fn = emulated["flash_attention"].flash_attention_launch
    fa_fn.argtypes = [i, i, p, p, p, p, i, i, i, i, i,
                      ctypes.POINTER(ctypes.c_longlong), f, i, i, f, i, i, p]
    gm_fn = emulated["grouped_matmul"].grouped_matmul_launch
    gm_fn.argtypes = [i, p, p, p, i, i, i, i, i, i, i, p, f, i, i, i, p]
    gm_dec_fn = emulated["grouped_matmul"].grouped_matmul_decode_launch
    gm_dec_fn.argtypes = [i, p, p, p, i, i, i, i, i, i, i, i, i, p, p, f, i,
                          i, i, p]
    qr_fn = emulated["quantize_rowwise"].quantize_rowwise_launch
    qr_fn.argtypes = [i, p, p, p, i, i, p]
    rg_fn = emulated["rglru_scan"].rglru_scan_launch
    rg_fn.argtypes = [p, p, p, p, p, i, i, i, p]
    wkv_fn = emulated["rwkv6_wkv"].rwkv6_wkv_launch
    wkv_fn.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    for fn in (mm_fn, dec_fn, fa_fn, gm_fn, gm_dec_fn, qr_fn, rg_fn,
               wkv_fn):
        fn.restype = i
    monkeypatch.setattr(mm, "_fn", mm_fn)
    monkeypatch.setattr(mm, "_decode_fn", dec_fn)
    select = mm.select_tile
    monkeypatch.setattr(mm, "select_tile", lambda *args: (
        "simt" if select(*args) == "tc" else select(*args)))
    monkeypatch.setattr(attn, "_fn", fa_fn)
    attn_select = attn.select_tile
    monkeypatch.setattr(attn, "select_tile", lambda *args: (
        "simt" if attn_select(*args) == "tc" else attn_select(*args)))
    monkeypatch.setattr(gm, "_fn", gm_fn)
    monkeypatch.setattr(gm, "_decode_fn", gm_dec_fn)
    monkeypatch.setattr(qr, "_fn", qr_fn)
    monkeypatch.setattr(rg, "_fn", rg_fn)
    monkeypatch.setattr(wkv, "_fn", wkv_fn)
    wkv_select = wkv.select_tile
    monkeypatch.setattr(wkv, "select_tile", lambda *args: (
        "simt" if wkv_select(*args) == "tc" else wkv_select(*args)))

    class _Stream:
        cuda_stream = None
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())


def _rel(out, ref):
    o, r = out.double(), ref.double()
    return ((o - r).abs().max() / (r.abs().max() + 1e-30)).item()


MM_CASES = [  # (m, k, n, dtype, epilogue fields, tol); m <= 8: decode tile
    (5, 72, 200, torch.float32, {}, 1e-5),
    # decode tile: M = 1, 4 and 8 rows, ragged N (scalar loads) and K,
    # every epilogue field, and K split across blocks (k >= 256: a
    # workspace and the fixed-order reduction kernel)
    (1, 40, 27, torch.bfloat16, dict(activation="relu"), 3e-2),
    (7, 300, 200, torch.float32, dict(bias="full", activation="tanh",
                                      has_residual=True), 1e-5),
    (4, 520, 90, torch.float16, dict(glu=True, activation="gelu_tanh",
                                     bias="row", has_scale_a=True,
                                     has_scale_b=True, has_residual=True,
                                     softcap=5.0), 3e-2),
    (8, 1100, 64, torch.int8, {}, 0.0),
    (2, 77, 515, torch.int8, dict(bias="row", has_scale_a=True,
                                  has_scale_b=True, activation="relu"), 1e-5),
    (6, 256, 1040, torch.bfloat16, dict(bias="row", activation="gelu"),
     3e-2),
    (3, 264, 512, torch.bfloat16, dict(glu=True, activation="silu",
                                       has_residual=True), 3e-2),
    (5, 72, 200, torch.bfloat16, dict(glu=True, activation="silu"), 3e-2),
    (70, 40, 96, torch.float32, dict(bias="row", activation="gelu",
                                     has_scale_a=True, has_scale_b=True,
                                     has_residual=True, softcap=3.0), 1e-5),
    (70, 40, 96, torch.float16, dict(glu=True, activation="relu2",
                                     bias="full"), 3e-2),
    (9, 257, 130, torch.float32, dict(bias="full", activation="tanh"), 1e-5),
    (3, 33, 64, torch.int8, {}, 0.0),
    (66, 48, 48, torch.int8, dict(bias="row", has_scale_a=True,
                                  has_scale_b=True, activation="sigmoid"),
     1e-5),
    (4, 64, 64, torch.bfloat16, dict(glu=True, activation="gelu_tanh",
                                     bias="row", has_residual=True), 3e-2),
    # fp8 (e4m3fn, e5m2): read a byte an element and decoded in the tile,
    # the plain version decoding the same values, both accumulating in
    # fp32: the decode tile at 1, 4 and 8 rows (K split across blocks,
    # ragged N, GLU) and the SIMT tile (ragged edges, every epilogue field)
    (4, 520, 90, torch.float8_e4m3fn, dict(glu=True, activation="silu"),
     1e-5),
    (1, 40, 27, torch.float8_e5m2, dict(activation="relu"), 1e-5),
    (8, 300, 200, torch.float8_e5m2, dict(bias="row", has_scale_a=True,
                                         has_scale_b=True), 1e-5),
    (70, 40, 96, torch.float8_e4m3fn, dict(bias="full", activation="gelu",
                                           has_residual=True, softcap=3.0),
     1e-5),
    (66, 48, 80, torch.float8_e5m2, dict(glu=True, activation="silu"), 1e-5),
    (9, 257, 130, torch.float8_e4m3fn, {}, 1e-5),
]


@pytest.mark.parametrize("case", MM_CASES, ids=lambda c: f"{c[0]}x{c[1]}x"
                         f"{c[2]}-{str(c[3])[6:]}-"
                         f"{'-'.join(c[4]) or 'plain'}")
def test_fused_matmul_source_vs_plain(bound, case):
    m, k, n, dt, fields, tol = case
    fields = dict(fields)
    bias = fields.pop("bias", None)
    g = torch.Generator().manual_seed(m * k + n)
    if dt == torch.int8:
        a = torch.randint(-127, 128, (m, k), generator=g, dtype=dt)
        b = torch.randint(-127, 128, (k, n), generator=g, dtype=dt)
    else:
        a = torch.randn(m, k, generator=g).to(dt)
        b = torch.randn(k, n, generator=g).to(dt)
    n_out = n // 2 if fields.get("glu") else n
    ops = EpilogueOperands(
        bias=(None if bias is None else
              torch.randn((n,) if bias == "row" else (m, n), generator=g)),
        scale_a=torch.rand(m, generator=g) if fields.get("has_scale_a")
        else None,
        scale_b=torch.rand(n, generator=g) if fields.get("has_scale_b")
        else None,
        residual=torch.randn(m, n_out, generator=g)
        if fields.get("has_residual") else None)
    trivial = dt == torch.int8 and not fields and bias is None
    ep = Epilogue(bias_type={None: BiasType.ZERO, "row": BiasType.ROW,
                             "full": BiasType.FULL}[bias],
                  out_dtype=(torch.int32 if trivial else torch.float32
                             if dt in (torch.int8,) + FP8 else dt), **fields)
    assert mm.tile_for(a, b, ep) == ("decode" if m <= 8 else "simt")
    out = mm.fused_matmul_cuda(a, b, ep, ops)
    ref = mm.fused_matmul_plain(a, b, ep, ops, torch.int32
                                if dt == torch.int8 else torch.float32)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    if trivial:
        assert torch.equal(out, ref)
    assert _rel(out, ref) <= tol


@pytest.mark.parametrize("m", [2, 9], ids=["decode", "simt"])
@pytest.mark.parametrize("dt", FP8, ids=lambda v: str(v)[6:])
def test_fused_matmul_source_decodes_every_fp8_code(bound, dt, m):
    """A K = 1 product by 1.0 gives B's values as the tile decoded them:
    every one of the 256 codes of both formats, subnormals, zeros,
    e5m2's infinities and both formats' NaNs, equal to torch's
    decoding."""
    a = torch.ones(m, 1).to(dt)
    b = torch.arange(256, dtype=torch.uint8).view(dt).reshape(1, 256)
    ep = Epilogue(out_dtype=torch.float32)
    assert mm.tile_for(a, b, ep) == ("decode" if m <= 8 else "simt")
    out = mm.fused_matmul_cuda(a, b, ep, EpilogueOperands())
    want = b.float().expand(m, 256)
    assert torch.equal(out.isnan(), want.isnan())
    ok = ~want.isnan()
    assert torch.equal(out[ok], want[ok])


def test_decode_split_covers_k_once():
    """Split K reaches every row exactly once, in ranges of whole
    64-row rounds, and only where N alone gives too few blocks, never
    past one wave."""
    for n_out, k in ((11008, 4096), (512, 4096), (4096, 11008),
                     (64000, 4096), (45, 520), (27, 40), (100, 129)):
        splits, k_split = mm.decode_split(n_out, k)
        assert k_split % mm.DECODE_ROUND == 0
        assert (splits - 1) * k_split < k <= splits * k_split
        tiles = -(-n_out // mm.DECODE_COLS)
        assert splits == 1 or tiles * splits <= mm.DECODE_BLOCKS
    assert mm.decode_split(64000, 4096) == (1, 4096)
    assert mm.decode_split(27, 40) == (1, 64)
    assert mm.decode_split(11008, 4096) == (6, 704)


# K1's calls on the served paths, (k, n, glu) per projection: prefill runs
# them at M = 4 x 221 = 884 and 4 x 90 = 360 rows, decode and each
# prefill's logits at M = 4.
SERVED_K1 = {
    "yi-6b": [(4096, 4096, False), (4096, 512, False), (4096, 22016, True),
              (11008, 4096, False)],
    "olmoe-1b-7b": [(2048, 2048, False), (2048, 64, False)],
    "recurrentgemma-2b": [(2560, 2560, False), (2560, 256, False),
                          (2560, 15360, True), (7680, 2560, False)],
    "rwkv6-7b": [(4096, 4096, False), (4096, 160, False), (4096, 64, False),
                 (4096, 14336, False), (14336, 4096, False)],
}
LOGITS_K1 = {"yi-6b": (4096, 64000), "olmoe-1b-7b": (2048, 50304),
             "recurrentgemma-2b": (2560, 256000), "rwkv6-7b": (4096, 65536)}


@pytest.mark.parametrize("arch", sorted(SERVED_K1))
def test_select_tile_on_served_shapes(arch):
    for k, n, glu in SERVED_K1[arch]:
        for m in (884, 360):
            assert mm.select_tile(m, n, k, torch.bfloat16, glu, True) == "tc"
        assert mm.select_tile(4, n, k, torch.bfloat16, glu, True) == "decode"
    k, n = LOGITS_K1[arch]
    assert mm.select_tile(4, n, k, torch.bfloat16, False, True) == "decode"


@pytest.mark.parametrize("case,tile", [
    ((884, 4096, 4096, torch.float16, False, True), "tc"),
    ((9, 4096, 4096, torch.bfloat16, False, True), "tc"),
    ((8, 4096, 4096, torch.bfloat16, False, True), "decode"),
    ((1, 37, 13, torch.float32, True, False), "decode"),
    ((4, 4096, 22016, torch.int8, False, True), "decode"),
    ((884, 4096, 4100, torch.bfloat16, False, True), "simt"),   # K % 8
    ((884, 4100, 4096, torch.bfloat16, False, True), "simt"),   # N % 8
    ((884, 40, 64, torch.bfloat16, True, True), "simt"),        # N/2 % 8
    ((884, 48, 64, torch.bfloat16, True, True), "tc"),
    ((884, 4096, 4096, torch.float32, False, True), "simt"),
    ((884, 4096, 4096, torch.int8, False, True), "simt"),
    ((884, 4096, 22016, torch.float8_e4m3fn, True, True), "simt"),
    ((884, 4096, 4096, torch.float8_e5m2, False, True), "simt"),
    ((4, 4096, 22016, torch.float8_e5m2, True, True), "decode"),
    ((884, 4096, 4096, torch.bfloat16, False, False), "simt"),  # unaligned
], ids=lambda v: "-".join(map(str, v)).replace("torch.", "")
    if isinstance(v, tuple) else v)
def test_select_tile_rule(case, tile):
    m, n, k, dt, glu, aligned = case
    assert mm.select_tile(m, n, k, dt, glu, aligned) == tile


def test_fused_matmul_cuda_takes_contiguous_operands():
    """The wrapper makes the operands contiguous before it launches, so
    that the tile it counts is the tile ``tile_for`` picks inside."""
    a, b = torch.zeros(64, 16).t(), torch.zeros(64, 32)
    with pytest.raises(ValueError, match="contiguous"):
        mm.fused_matmul_cuda(a, b, Epilogue(out_dtype=torch.float32),
                             EpilogueOperands())


ATTN_CASES = [  # (b, h, hkv, sq, sk, d, dtype, flags)
    (1, 4, 2, 70, 70, 32, torch.float32, dict(causal=True)),
    (2, 4, 1, 33, 100, 64, torch.float32, dict(causal=True, window=16,
                                              softcap=5.0, q_start=40)),
    (1, 2, 2, 20, 50, 16, torch.bfloat16, dict(causal=False)),
    (1, 2, 1, 40, 10, 128, torch.float16, dict(causal=True)),
    # RecurrentGemma's heads: MQA, head_dim 256, a window
    (1, 2, 1, 70, 70, 256, torch.float32, dict(causal=True, window=16)),
    (1, 2, 1, 20, 30, 256, torch.bfloat16, dict(causal=True)),
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: f"q{c[3]}k{c[4]}"
                         f"d{c[5]}-{str(c[6])[6:]}")
def test_flash_attention_source_vs_plain(bound, case):
    b, h, hkv, sq, sk, d, dt, flags = case
    g = torch.Generator().manual_seed(sq * sk + d)
    q = torch.randn(b, h, sq, d, generator=g).to(dt)
    k, v = (torch.randn(b, hkv, sk, d, generator=g).to(dt) for _ in range(2))
    kw = dict(sm_scale=d ** -0.5, window=0, softcap=0.0, q_start=0) | flags
    out, tile = attn.flash_attention_cuda(q, k, v, **kw)
    ref = attn.flash_attention_plain(q, k, v, **kw)
    assert tile == "simt"
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert _rel(out, ref) <= (1e-3 if dt == torch.float32 else 4e-2)


def test_flash_attention_tc_source_is_card_only(emulated):
    """The emulated build leaves out K2's tensor-core tile, whose TMA and
    wgmma have no CPU stand-in, and keeps its SIMT tile."""
    assert "flash_attention_sm90" in build.CARD_ONLY
    assert (build.CSRC / "flash_attention_sm90.cu").exists()
    assert "flash_attention_sm90" not in emulated
    assert "flash_attention" in emulated


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16],
                         ids=lambda v: str(v)[6:])
def test_flash_attention_source_on_transposed_views(bound, dt):
    """q, k, v as ``qkv_project`` passes them: (B, S, H, D) memory seen
    as (B, H, S, D), which the rule sends to the tensor-core tile on the
    card and the emulation runs on the SIMT tile through its strides."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 37, 4, 128, generator=g).to(dt).transpose(1, 2)
    k, v = (torch.randn(2, 37, 2, 128, generator=g).to(dt).transpose(1, 2)
            for _ in range(2))
    kw = dict(sm_scale=128 ** -0.5, causal=True, window=16, softcap=0.0,
              q_start=0)
    out, _ = attn.flash_attention_cuda(q, k, v, **kw)
    ref = attn.flash_attention_plain(q, k, v, **kw)
    assert _rel(out, ref) <= 4e-2


def test_flash_attention_source_fully_masked_rows_are_zero(bound):
    q = torch.randn(1, 2, 8, 32)
    k, v = torch.randn(1, 1, 40, 32), torch.randn(1, 1, 40, 32)
    out, _ = attn.flash_attention_cuda(q, k, v, sm_scale=32 ** -0.5,
                                       causal=True, window=4, softcap=0.0,
                                       q_start=100)
    assert torch.equal(out, torch.zeros_like(out))


INT8_ATTN_CASES = [  # (b, h, hkv, sq, sk, d, flags)
    (1, 4, 2, 70, 70, 32, dict(causal=True)),
    (2, 4, 1, 33, 100, 64, dict(causal=True, window=16, q_start=40)),
    (2, 4, 4, 32, 32, 16, dict(causal=True)),     # padded to 32
    (1, 2, 1, 20, 30, 128, dict(causal=False, softcap=5.0)),
]


def _int8_qkv(b, h, hkv, sq, sk, d, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.randint(-8, 9, (b, h, sq, d), generator=g, dtype=torch.int8)
    k, v = (torch.randint(-127, 128, (b, hkv, sk, d), generator=g,
                          dtype=torch.int8) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("case", INT8_ATTN_CASES,
                         ids=lambda c: f"q{c[3]}k{c[4]}d{c[5]}")
def test_flash_attention_source_int8(bound, case):
    """int8 q, k, v on the SIMT tile: read as they lie, fp32 inside, the
    output truncated toward zero into int8 as the plain version's cast
    truncates; the two sum in other orders, so an element whose fp32
    value lies at a whole number may truncate one apart: within 1 at
    every element."""
    b, h, hkv, sq, sk, d, flags = case
    q, k, v = _int8_qkv(b, h, hkv, sq, sk, d, sq * sk + d)
    kw = dict(sm_scale=d ** -0.5, window=0, softcap=0.0, q_start=0) | flags
    out, tile = attn.flash_attention_cuda(q, k, v, **kw)
    ref = attn.flash_attention_plain(q, k, v, **kw)
    assert tile == "simt" and attn.tile_for(q, k, v) == "simt"
    assert out.dtype == ref.dtype == torch.int8 and out.shape == ref.shape
    assert (out.int() - ref.int()).abs().max() <= 1


def test_flash_attention_source_int8_paged_and_masked(bound):
    """Paged int8 K and V through the kernel equal the contiguous call bit
    for bit; a fully masked int8 row is 0."""
    from repro_torch.kernels.attention.paged import gather_paged, to_paged
    q, k, v = _int8_qkv(2, 4, 2, 32, 32, 16, 3)
    kw = dict(sm_scale=0.25, causal=True, window=0, softcap=0.0, q_start=0)
    want, _ = attn.flash_attention_cuda(q, k, v, **kw)
    kp, vp, table = to_paged(k, v, 8, seed=5)
    got, _ = attn.flash_attention_cuda(q, gather_paged(kp, table, 32),
                                       gather_paged(vp, table, 32), **kw)
    assert got.dtype == torch.int8 and torch.equal(got, want)
    out, _ = attn.flash_attention_cuda(q, k, v, **kw | dict(window=4,
                                                            q_start=100))
    assert torch.equal(out, torch.zeros_like(out))


GM_CASES = [  # (e, c, k, n, dtype, epilogue fields, tol, tile the rule picks)
    (3, 5, 72, 200, torch.float32, {}, 1e-5, "decode"),
    (2, 8, 64, 96, torch.bfloat16, dict(glu=True, activation="silu"), 3e-2,
     "decode"),
    (2, 70, 40, 96, torch.float32, dict(glu=True, activation="gelu"), 1e-5,
     "simt"),
    (2, 66, 48, 64, torch.float16, dict(activation="relu2", softcap=4.0),
     3e-2, "tc"),
    (2, 9, 33, 64, torch.int8, {}, 0.0, "simt"),
    # the decode tile with several experts: C = 1, 4 and 8, GLU and not,
    # every input type, K split across blocks (all but the last two)
    (3, 1, 300, 40, torch.bfloat16, dict(glu=True, activation="silu"), 3e-2,
     "decode"),
    (2, 4, 520, 90, torch.float16, dict(activation="gelu_tanh",
                                        softcap=5.0), 3e-2, "decode"),
    (3, 8, 1100, 64, torch.int8, {}, 0.0, "decode"),
    (2, 4, 256, 130, torch.float32, dict(glu=True, activation="tanh"), 1e-5,
     "decode"),
    (4, 1, 40, 27, torch.int8, {}, 0.0, "decode"),
    (2, 8, 100, 48, torch.float16, dict(glu=True, activation="relu"), 3e-2,
     "decode"),
    # fp8, fp32 out: the decode tile with K split, and the SIMT tile
    (3, 8, 520, 64, torch.float8_e4m3fn, dict(glu=True, activation="silu"),
     1e-5, "decode"),
    (2, 4, 72, 40, torch.float8_e5m2, {}, 1e-5, "decode"),
    (2, 70, 48, 64, torch.float8_e5m2, dict(glu=True, activation="silu"),
     1e-5, "simt"),
    (2, 9, 40, 48, torch.float8_e4m3fn, dict(activation="relu"), 1e-5,
     "simt"),
]
SELECT_TILE = mm.select_tile     # the rule itself, before ``bound`` patches
SELECT_WKV = wkv.select_tile


def _gm_inputs(e, c, k, n, dt, seed):
    g = torch.Generator().manual_seed(seed)
    if dt == torch.int8:
        return (torch.randint(-127, 128, (e, c, k), generator=g, dtype=dt),
                torch.randint(-127, 128, (e, k, n), generator=g, dtype=dt))
    return (torch.randn(e, c, k, generator=g).to(dt),
            (torch.randn(e, k, n, generator=g) / k ** .5).to(dt))


def _gm_check(x, w, fields, tol, tile, x_ref=None, **promises):
    """K4's source on ``x`` against the plain version on ``x_ref`` (x
    unless given), each expert on its own scale; the tile the rule picks
    (the SIMT tile stands in for ``"tc"``)."""
    e, c, k = x.shape
    int8 = x.dtype == torch.int8
    ep = Epilogue(out_dtype=torch.int32 if int8 else torch.float32
                  if x.dtype in FP8 else x.dtype, **fields)
    assert SELECT_TILE(c, w.shape[2], k, x.dtype, ep.glu, True) == tile
    assert gm.tile_for(x, w, ep) == ("simt" if tile == "tc" else tile)
    out = gm.grouped_matmul_cuda(x, w, ep, **promises)
    ref = gm.grouped_matmul_plain(x if x_ref is None else x_ref, w, ep,
                                  torch.int32 if int8 else torch.float32)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    if int8:
        assert torch.equal(out, ref)
    for i in range(e):
        assert _rel(out[i], ref[i]) <= tol


@pytest.mark.parametrize("case", GM_CASES, ids=lambda c: f"{c[0]}x{c[1]}x"
                         f"{c[2]}x{c[3]}-{str(c[4])[6:]}-"
                         f"{'-'.join(c[5]) or 'plain'}")
def test_grouped_matmul_source_vs_plain(bound, case):
    e, c, k, n, dt, fields, tol, tile = case
    x, w = _gm_inputs(e, c, k, n, dt, e * c * k + n)
    _gm_check(x, w, fields, tol, tile)


GM_ROWS_CASES = [  # (e, c, k, n, dtype, fields, rows, max_rows, max_experts,
    #                 tol, tile)
    # the decode tile: empty experts, K split across blocks
    (4, 8, 300, 64, torch.bfloat16, dict(glu=True, activation="silu"),
     [3, 0, 8, 1], None, None, 3e-2, "decode"),
    # max_rows below C (4 of 8 rows in registers), max_experts splitting K
    (4, 8, 520, 96, torch.int8, {}, [4, 0, 2, 0], 4, 2, 0.0, "decode"),
    (3, 8, 64, 40, torch.float16, dict(activation="silu"), [1, 0, 1], 1, 2,
     3e-2, "decode"),
    # every expert empty: epilogue(0) everywhere (0.5 under sigmoid)
    (3, 4, 64, 40, torch.float32, dict(activation="sigmoid"), [0, 0, 0],
     None, None, 1e-5, "decode"),
    # the SIMT tile: an empty expert, one full 64-row tile and a skipped
    # one, a partial last row tile, a full expert
    (4, 70, 48, 64, torch.float32, dict(glu=True, activation="gelu"),
     [0, 64, 66, 70], None, None, 1e-5, "simt"),
    (3, 70, 40, 48, torch.int8, {}, [70, 0, 5], None, None, 0.0, "simt"),
    # the tensor-core tile's calls (on the SIMT tile here), all empty
    (2, 70, 48, 64, torch.bfloat16, dict(activation="relu"), [0, 0], None,
     None, 3e-2, "tc"),
]


@pytest.mark.parametrize("case", GM_ROWS_CASES,
                         ids=lambda c: f"{c[1]}-{str(c[4])[6:]}-rows"
                         f"{'_'.join(map(str, c[6]))}-{c[10]}")
def test_grouped_matmul_source_with_rows(bound, case):
    """``rows`` promises zeros from rows[e] on; the result equals the
    plain version on the zero-padded x.  What no block of the tile may
    load (every row at or past rows[e] on the decode tile, whole 64-row
    tiles at or past it on the SIMT tile) is poisoned with NaN (127 in
    int8), so a load of it would show in the result."""
    e, c, k, n, dt, fields, rows, max_rows, max_experts, tol, tile = case
    x, w = _gm_inputs(e, c, k, n, dt, e * c * k + n + 1)
    x_ref = x.clone()
    for i, r in enumerate(rows):
        x_ref[i, r:] = 0
        skip = r if tile == "decode" else -(-r // 64) * 64
        x[i, :skip] = x_ref[i, :skip]
        x[i, skip:] = 127 if dt == torch.int8 else float("nan")
    _gm_check(x, w, fields, tol, tile, x_ref,
              rows=torch.tensor(rows, dtype=torch.int32), max_rows=max_rows,
              max_experts=max_experts)
    if tile == "decode":       # the split cases really split
        n_out = n // 2 if fields.get("glu") else n
        splits, _ = mm.decode_split(n_out, k, max_experts or e)
        assert (splits > 1) == (k >= 256)


@pytest.mark.parametrize("tokens,tile", [(884, "tc"), (360, "tc"),
                                         (4, "decode")])
def test_select_tile_on_olmoe_grouped_shapes(tokens, tile):
    """OLMoE's two expert GEMMs at the capacity of the served prefills
    (C = 144 and 64) and of decode (C = 8), bf16."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.moe import moe_capacity
    cfg = get_config("olmoe-1b-7b")
    c = moe_capacity(cfg, tokens)
    assert c == {884: 144, 360: 64, 4: 8}[tokens]
    d, ff = cfg.d_model, cfg.moe.d_ff_expert
    for k, n, glu in ((d, 2 * ff, True), (ff, d, False)):
        assert mm.select_tile(c, n, k, torch.bfloat16, glu, True) == tile


def _ties(m, k, dt):
    """Rows whose absmax is 127, so x / scale is x itself: the .5 and
    -.5 entries land exactly on ties; one row is all zeros."""
    g = torch.Generator().manual_seed(m * k)
    x = (torch.randint(-254, 255, (m, k), generator=g) / 2.0)
    x[:, 0] = 127.0
    x[1] = 0.0
    return x.to(dt)


# quantize_rowwise.cu's register path takes rows of whole 16-byte vectors
# (K % 4 == 0 in fp32, K % 8 == 0 in 16 bits) of at most 16 x 768
# elements from an aligned base; the loop path every other row
@pytest.mark.parametrize("m,k,dt", [(37, 200, torch.float32),
                                    (5, 300, torch.bfloat16),
                                    (3, 64, torch.float16),
                                    (7, 512, torch.float32),
                                    (7, 512, torch.bfloat16),
                                    (7, 512, torch.float16),
                                    (3, 11008, torch.float32),
                                    (5, 301, torch.float32),
                                    (2, 16400, torch.float32)],
                         ids=lambda v: str(v).replace("torch.", ""))
def test_quantize_rowwise_source_bit_exact(bound, m, k, dt):
    g = torch.Generator().manual_seed(k)
    for x in ((torch.randn(m, k, generator=g) * 3).to(dt), _ties(m, k, dt)):
        q, s = qr.quantize_rowwise_cuda(x)
        q_ref, s_ref = qr.quantize_rowwise_plain(x)
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert torch.equal(q, q_ref) and torch.equal(s, s_ref)


def test_quantize_rowwise_source_unaligned_base(bound):
    """Rows of whole vectors from a base 4 bytes past a 16-byte boundary
    take the loop path, bit-exact too."""
    g = torch.Generator().manual_seed(3)
    x = (torch.randn(6 * 512 + 1, generator=g) * 3)[1:].view(6, 512)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    q, s = qr.quantize_rowwise_cuda(x)
    q_ref, s_ref = qr.quantize_rowwise_plain(x)
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)


# the chunked scan (chunks of rglru_scan.cu's CHUNK steps, 32 channels a
# block): T shorter and longer than a chunk with a ragged tail, C a
# multiple of 32 or not, T = 1
@pytest.mark.parametrize("b,t,c,h0", [(2, 37, 300, True), (1, 5, 64, False),
                                      (3, 1, 17, True), (2, 70, 300, True),
                                      (3, 40, 17, False), (2, 1, 64, False),
                                      (1, 131, 33, True)])
def test_rglru_scan_source_vs_plain(bound, b, t, c, h0):
    g = torch.Generator().manual_seed(t * c)
    log_a = -torch.nn.functional.softplus(torch.randn(b, t, c, generator=g))
    x = torch.randn(b, t, c, generator=g)
    init = torch.randn(b, c, generator=g) if h0 else None
    # the reference first: in a fresh process, the first parallel torch
    # op after the emulation's thousands of threads has returned wrong
    # values in one worker's share of the tensor
    ref, ref_last = rg.rglru_scan_plain(log_a, x, init)
    h, h_last = rg.rglru_scan_cuda(log_a, x, init)
    assert h.dtype == ref.dtype and h.shape == ref.shape
    assert _rel(h, ref) <= 1e-5 and _rel(h_last, ref_last) <= 1e-5


def test_rglru_scan_source_pure_integrator_limit(bound):
    """log_a -> 0: a -> 1 and beta -> 0, so the scan keeps h0 over chunks."""
    g = torch.Generator().manual_seed(9)
    x = torch.randn(2, 70, 40, generator=g)
    init = torch.randn(2, 40, generator=g)
    log_a = torch.full_like(x, -1e-9)
    ref, ref_last = rg.rglru_scan_plain(log_a, x, init)
    h, h_last = rg.rglru_scan_cuda(log_a, x, init)
    assert _rel(h, ref) <= 1e-5 and _rel(h_last, ref_last) <= 1e-5
    assert (h_last - init).abs().max() < 0.05


WKV_CASES = [  # (b, h, t, c, chunk, dtype, initial state, tol)
    (1, 2, 64, 64, 64, torch.float32, False, 1e-4),
    (2, 1, 45, 32, 32, torch.float32, True, 1e-4),       # ragged, 2 chunks
    (1, 2, 70, 64, 64, torch.bfloat16, True, 3e-2),
    (1, 1, 5, 16, 32, torch.float16, False, 3e-2),
]


@pytest.mark.parametrize("case", WKV_CASES, ids=lambda c: f"t{c[2]}c{c[3]}"
                         f"L{c[4]}-{str(c[5])[6:]}{'-s0' if c[6] else ''}")
def test_rwkv6_wkv_source_vs_plain(bound, case):
    b, h, t, c, chunk, dt, with_s0, tol = case
    g = torch.Generator().manual_seed(t * c + chunk)
    r, k, v = (torch.randn(b, h, t, c, generator=g).to(dt) for _ in range(3))
    lw = -torch.exp(torch.randn(b, h, t, c, generator=g) * 0.5)
    u = torch.randn(h, c, generator=g) * 0.5
    s0 = torch.randn(b, h, c, c, generator=g) * 0.3 if with_s0 else None
    o, s, tile = wkv.rwkv6_wkv_cuda(r, k, v, lw, u, chunk=chunk,
                                    initial_state=s0)
    ref, ref_s = wkv.rwkv6_chunked(r, k, v, lw, u, chunk=chunk,
                                   initial_state=s0)
    assert tile == "simt"
    assert o.dtype == ref.dtype == dt and o.shape == ref.shape
    assert _rel(o, ref) <= tol and _rel(s, ref_s) <= 1e-4


def test_rwkv6_wkv_tc_source_is_card_only(emulated):
    """The emulated build leaves out K6's tensor-core tile, whose mma.sync
    has no CPU stand-in, and keeps its SIMT tile."""
    assert "rwkv6_wkv_sm90" in build.CARD_ONLY
    assert (build.CSRC / "rwkv6_wkv_sm90.cu").exists()
    assert "rwkv6_wkv_sm90" not in emulated
    assert "rwkv6_wkv" in emulated


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16],
                         ids=lambda v: str(v)[6:])
def test_rwkv6_wkv_tc_calls_run_on_the_simt_source(bound, dt):
    """r, k, v and lw as ``time_mix`` passes them ((B, T, H, C) memory
    seen as (B, H, T, C)), which the rule sends to the tensor-core tile
    on the card; the emulation runs them on the SIMT tile, on copies."""
    g = torch.Generator().manual_seed(11)
    b, t, h, c = 2, 45, 2, 64
    r, k, v = (torch.randn(b, t, h, c, generator=g).to(dt).transpose(1, 2)
               for _ in range(3))
    lw = -torch.exp(torch.randn(b, t, h, c, generator=g) * 0.5).transpose(
        1, 2)
    u = torch.randn(h, c, generator=g) * 0.5
    assert SELECT_WKV(dt, c, 64, True, [t * h * c * 2, c * 2, h * c * 2]) \
        == "tc"
    o, s, tile = wkv.rwkv6_wkv_cuda(r, k, v, lw, u, chunk=64)
    ref, ref_s = wkv.rwkv6_chunked(r, k, v, lw, u, chunk=64)
    assert tile == "simt"
    assert _rel(o, ref) <= 3e-2 and _rel(s, ref_s) <= 1e-4
