"""The CUDA kernels (K1 fused matmul, K2 flash attention, K3 row
quantiser, K4 grouped MoE matmul, K5 RG-LRU scan, K6 chunked RWKV-6 WKV)
against their plain versions on the card, at small and ragged shapes.

These need a Hopper card and nvcc; elsewhere they skip.  On the card:

    PYTHONPATH=src python -m pytest -m sm90 tests/test_torch_kernels_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.fusion import Epilogue, EpilogueOperands  # noqa: E402
from repro_torch.core.task import BiasType                   # noqa: E402
from repro_torch.kernels.attention import ops as attn_ops    # noqa: E402
from repro_torch.kernels.attention.attention import (        # noqa: E402
    flash_attention_plain)
from repro_torch.kernels.matmul import ops as mm_ops         # noqa: E402
from repro_torch.kernels.matmul.matmul import fused_matmul_plain  # noqa: E402
from repro_torch.kernels.moe import ops as gm_ops            # noqa: E402
from repro_torch.kernels.moe.grouped_matmul import (         # noqa: E402
    grouped_matmul_plain)
from repro_torch.kernels.quant import ops as q_ops           # noqa: E402
from repro_torch.kernels.quant.quant import (              # noqa: E402
    quantize_rowwise_plain)
from repro_torch.kernels.rglru import ops as rg_ops          # noqa: E402
from repro_torch.kernels.rglru.rglru import rglru_scan_plain  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wkv_ops         # noqa: E402
from repro_torch.kernels.rwkv6.rwkv6 import rwkv6_chunked    # noqa: E402

pytestmark = pytest.mark.sm90


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(out, ref):
    o, r = out.double(), ref.double()
    return ((o - r).abs().max() / (r.abs().max() + 1e-30)).item()


MM_CASES = [  # (m, k, n, dtype, out dtype, epilogue fields, tol)
    (5, 72, 200, torch.bfloat16, None, {}, 3e-2),
    (4, 256, 512, torch.bfloat16, None, dict(glu=True, activation="silu"),
     3e-2),
    (70, 96, 130, torch.float32, None, dict(bias="full", activation="gelu",
                                            has_residual=True), 1e-5),
    (33, 257, 96, torch.float16, None, dict(bias="row", softcap=5.0), 3e-2),
    (9, 100, 70, torch.int8, torch.int32, {}, 0.0),
    (66, 64, 48, torch.int8, torch.float32, dict(
        has_scale_a=True, has_scale_b=True, bias="row",
        activation="relu2"), 1e-5),
]


@pytest.mark.parametrize("case", MM_CASES, ids=lambda c: f"{c[0]}x{c[1]}x"
                         f"{c[2]}-{str(c[3])[6:]}-{'-'.join(c[5]) or 'plain'}")
def test_fused_matmul_kernel_vs_plain(card, case):
    m, k, n, dt, out_dt, fields, tol = case
    fields = dict(fields)
    bias = fields.pop("bias", None)
    if dt == torch.int8:
        a = torch.randint(-127, 128, (m, k), generator=card, device="cuda",
                          dtype=dt)
        b = torch.randint(-127, 128, (k, n), generator=card, device="cuda",
                          dtype=dt)
    else:
        a = torch.randn(m, k, generator=card, device="cuda").to(dt)
        b = (torch.randn(k, n, generator=card, device="cuda") / k ** .5).to(dt)
    n_out = n // 2 if fields.get("glu") else n

    def rnd(*shape):
        return torch.randn(*shape, generator=card, device="cuda")
    ops = EpilogueOperands(
        bias=None if bias is None else rnd(*((n,) if bias == "row" else
                                             (m, n))),
        scale_a=rnd(m).abs() if fields.get("has_scale_a") else None,
        scale_b=rnd(n).abs() if fields.get("has_scale_b") else None,
        residual=rnd(m, n_out) if fields.get("has_residual") else None)
    ep = Epilogue(bias_type={None: BiasType.ZERO, "row": BiasType.ROW,
                             "full": BiasType.FULL}[bias],
                  out_dtype=out_dt or (torch.float32 if dt == torch.int8
                                       else dt), **fields)
    before = mm_ops.fused_matmul.launches
    out = mm_ops.fused_matmul(a, b, epilogue=ep, operands=ops)
    assert mm_ops.fused_matmul.launches == before + 1
    ref = fused_matmul_plain(a, b, ep, ops, torch.int32 if dt == torch.int8
                             else torch.float32)
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert _rel(out, ref) <= tol


def test_fused_matmul_kernel_refuses_fp8(card):
    a = torch.zeros(4, 32, device="cuda").to(torch.float8_e4m3fn)
    with pytest.raises(NotImplementedError):
        mm_ops.fused_matmul(a, a.T.contiguous())


ATTN_CASES = [  # (b, h, hkv, sq, sk, d, dtype, flags, tol)
    (1, 4, 2, 70, 70, 128, torch.bfloat16, dict(causal=True), 4e-2),
    (2, 4, 1, 33, 100, 64, torch.float32, dict(causal=True, window=16,
                                              softcap=5.0, q_start=40), 1e-3),
    (1, 2, 2, 20, 50, 16, torch.float16, dict(causal=False), 4e-2),
    (2, 10, 1, 90, 90, 256, torch.bfloat16, dict(causal=True, window=32),
     4e-2),
    (1, 10, 1, 70, 70, 256, torch.float32, dict(causal=True, window=16),
     1e-3),
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: f"q{c[3]}k{c[4]}"
                         f"d{c[5]}-{str(c[6])[6:]}")
def test_flash_attention_kernel_vs_plain(card, case):
    b, h, hkv, sq, sk, d, dt, flags, tol = case
    q = torch.randn(b, h, sq, d, generator=card, device="cuda").to(dt)
    k, v = (torch.randn(b, hkv, sk, d, generator=card, device="cuda").to(dt)
            for _ in range(2))
    before = attn_ops.flash_attention.launches
    out = attn_ops.flash_attention(q, k, v, **flags)
    assert attn_ops.flash_attention.launches == before + 1
    kw = dict(sm_scale=d ** -0.5, window=0, softcap=0.0, q_start=0) | flags
    ref = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert _rel(out, ref) <= tol


def test_flash_attention_fully_masked_rows_are_zero(card):
    q = torch.randn(1, 2, 8, 32, generator=card, device="cuda")
    k, v = (torch.randn(1, 1, 40, 32, generator=card, device="cuda")
            for _ in range(2))
    out = attn_ops.flash_attention(q, k, v, causal=True, window=4,
                                   q_start=100)
    assert torch.equal(out, torch.zeros_like(out))


def test_async_engine_uses_a_side_stream(card):
    from repro_torch.core import AsyncMatmulEngine, MatMulTask, Status
    eng = AsyncMatmulEngine()
    a = torch.ones(64, 128, device="cuda")
    b = torch.ones(128, 32, device="cuda")
    task = MatMulTask(m=64, n=32, k=128)
    h = eng.dispatch(task, a, b)
    assert task.status is Status.RUNNING and h.event is not None
    out = eng.wait(h)
    assert task.status is Status.DONE and eng.check(h)
    assert torch.equal(out, torch.full((64, 32), 128.0, device="cuda"))


GM_CASES = [  # (e, c, k, n, dtype, epilogue fields, tol); c <= 8: decode tile
    (5, 33, 72, 200, torch.float32, dict(glu=True, activation="gelu"), 1e-5),
    (4, 8, 256, 512, torch.bfloat16, dict(glu=True, activation="silu"),
     3e-2),
    (3, 70, 96, 130, torch.float16, {}, 3e-2),
    (3, 9, 100, 70, torch.int8, {}, 0.0),
]


@pytest.mark.parametrize("case", GM_CASES, ids=lambda c: f"{c[0]}x{c[1]}x"
                         f"{c[2]}x{c[3]}-{str(c[4])[6:]}")
def test_grouped_matmul_kernel_vs_plain(card, case):
    e, c, k, n, dt, fields, tol = case
    if dt == torch.int8:
        x = torch.randint(-127, 128, (e, c, k), generator=card,
                          device="cuda", dtype=dt)
        w = torch.randint(-127, 128, (e, k, n), generator=card,
                          device="cuda", dtype=dt)
    else:
        x = torch.randn(e, c, k, generator=card, device="cuda").to(dt)
        w = (torch.randn(e, k, n, generator=card, device="cuda")
             / k ** .5).to(dt)
    ep = Epilogue(**fields)
    before = gm_ops.grouped_matmul.launches
    out = gm_ops.grouped_matmul(x, w, epilogue=ep)
    assert gm_ops.grouped_matmul.launches == before + 1
    int8 = dt == torch.int8
    ref = grouped_matmul_plain(
        x, w, Epilogue(out_dtype=torch.int32 if int8 else dt, **fields),
        torch.int32 if int8 else torch.float32)
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype and out.shape == ref.shape
    if int8:
        assert torch.equal(out, ref)
    assert _rel(out, ref) <= tol


@pytest.mark.parametrize("m,k,dt", [(37, 200, torch.float32),
                                    (64, 4096, torch.bfloat16),
                                    (5, 300, torch.float16)],
                         ids=lambda v: str(v).replace("torch.", ""))
def test_quantize_rowwise_kernel_bit_exact(card, m, k, dt):
    x = (torch.randn(m, k, generator=card, device="cuda") * 3).to(dt)
    x[1] = 0
    ties = torch.randint(-254, 255, (m, k), generator=card,
                         device="cuda") / 2.0
    ties[:, 0] = 127.0
    for inp in (x, ties.to(dt)):
        before = q_ops.quantize_rowwise.launches
        q, s = q_ops.quantize_rowwise(inp)
        assert q_ops.quantize_rowwise.launches == before + 1
        q_ref, s_ref = quantize_rowwise_plain(inp)
        torch.cuda.synchronize()
        assert torch.equal(q, q_ref) and torch.equal(s, s_ref)


@pytest.mark.parametrize("b,t,c,h0", [(4, 221, 2560, True),
                                      (2, 37, 300, False), (3, 1, 17, True)])
def test_rglru_scan_kernel_vs_plain(card, b, t, c, h0):
    log_a = -torch.nn.functional.softplus(
        torch.randn(b, t, c, generator=card, device="cuda"))
    x = torch.randn(b, t, c, generator=card, device="cuda")
    init = torch.randn(b, c, generator=card, device="cuda") if h0 else None
    before = rg_ops.rglru_scan.launches
    h, h_last = rg_ops.rglru_scan(log_a, x, init)
    assert rg_ops.rglru_scan.launches == before + 1
    ref, ref_last = rglru_scan_plain(log_a, x, init)
    torch.cuda.synchronize()
    assert h.shape == ref.shape and h.dtype == torch.float32
    assert _rel(h, ref) <= 1e-5 and _rel(h_last, ref_last) <= 1e-5


WKV_CASES = [  # (b, h, t, c, chunk, dtype, initial state, tol)
    (2, 8, 221, 64, 64, torch.bfloat16, True, 3e-2),
    (2, 4, 100, 64, 32, torch.float32, False, 1e-4),
    (1, 3, 45, 32, 64, torch.float32, True, 1e-4),
    (1, 2, 5, 16, 32, torch.float16, False, 3e-2),
]


@pytest.mark.parametrize("case", WKV_CASES, ids=lambda c: f"t{c[2]}c{c[3]}"
                         f"L{c[4]}-{str(c[5])[6:]}{'-s0' if c[6] else ''}")
def test_rwkv6_wkv_kernel_vs_plain(card, case):
    b, h, t, c, chunk, dt, with_s0, tol = case
    r, k, v = (torch.randn(b, h, t, c, generator=card, device="cuda").to(dt)
               for _ in range(3))
    lw = -torch.exp(torch.randn(b, h, t, c, generator=card, device="cuda"))
    u = torch.randn(h, c, generator=card, device="cuda") * 0.5
    s0 = (torch.randn(b, h, c, c, generator=card, device="cuda") * 0.3
          if with_s0 else None)
    before = wkv_ops.rwkv6_scan.launches
    o, s = wkv_ops.rwkv6_scan(r, k, v, lw, u, chunk=chunk, initial_state=s0)
    assert wkv_ops.rwkv6_scan.launches == before + 1
    ref, ref_s = rwkv6_chunked(r, k, v, lw, u, chunk=chunk, initial_state=s0)
    torch.cuda.synchronize()
    assert o.dtype == ref.dtype == dt and o.shape == ref.shape
    assert _rel(o, ref) <= tol and _rel(s, ref_s) <= 1e-4
