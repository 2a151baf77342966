"""The CUDA kernels (K1 fused matmul, K2 flash attention, K3 row
quantiser, K4 grouped MoE matmul, K5 RG-LRU scan, K6 chunked RWKV-6 WKV)
against their plain versions on the card, at small and ragged shapes; K1,
K2, K4 and K6 on each of their tiles, K4 with and without its zero-row
promises; K1 and K4 on fp8 (e4m3fn, e5m2) and K2 on int8 (contiguous
and paged).

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


def _row_rel(out, ref):
    """The largest of each row's max |out - ref| over its own max |ref|
    (absolute where ref's row is 0): late causal rows, which average many
    keys, are held as tightly as row 0."""
    o, r = out.double(), ref.double()
    scale = r.abs().amax(-1)
    return ((o - r).abs().amax(-1)
            / torch.where(scale > 0, scale, 1.0)).max().item()


MM_CASES = [  # (m, k, n, dtype, out dtype, epilogue fields, tol, tile)
    (5, 72, 200, torch.bfloat16, None, {}, 3e-2, "decode"),
    (4, 256, 512, torch.bfloat16, None, dict(glu=True, activation="silu"),
     3e-2, "decode"),
    (70, 96, 130, torch.float32, None, dict(bias="full", activation="gelu",
                                            has_residual=True), 1e-5, "simt"),
    (33, 257, 96, torch.float16, None, dict(bias="row", softcap=5.0), 3e-2,
     "simt"),
    (9, 100, 70, torch.int8, torch.int32, {}, 0.0, "simt"),
    (66, 64, 48, torch.int8, torch.float32, dict(
        has_scale_a=True, has_scale_b=True, bias="row",
        activation="relu2"), 1e-5, "simt"),
    # tensor-core tile: ragged M (70, 360, 884), K not a multiple of 64,
    # GLU with silu and gelu_tanh, every epilogue field, bf16 and fp16
    (70, 96, 256, torch.bfloat16, None, dict(glu=True, activation="silu"),
     3e-2, "tc"),
    (360, 1000, 384, torch.bfloat16, None, dict(
        bias="row", has_scale_a=True, has_scale_b=True, has_residual=True,
        softcap=30.0, activation="gelu"), 3e-2, "tc"),
    (884, 4096, 1024, torch.bfloat16, None, dict(
        glu=True, activation="gelu_tanh", bias="full"), 3e-2, "tc"),
    (200, 520, 304, torch.float16, None, dict(glu=True, activation="silu",
                                              has_residual=True), 3e-2, "tc"),
    (130, 136, 200, torch.float16, torch.float32, dict(
        activation="relu2", softcap=5.0), 3e-2, "tc"),
    (9, 64, 64, torch.bfloat16, None, {}, 3e-2, "tc"),
    # decode tile at M = 1, 4 and 8, K split across blocks where N is
    # narrow (all but the 100-deep case)
    (1, 4096, 512, torch.bfloat16, None, {}, 3e-2, "decode"),
    (4, 4096, 22016, torch.bfloat16, None, dict(glu=True, activation="silu"),
     3e-2, "decode"),
    (8, 11008, 4096, torch.bfloat16, None, dict(has_residual=True), 3e-2,
     "decode"),
    (4, 4096, 6400, torch.bfloat16, torch.float32, dict(softcap=30.0), 3e-2,
     "decode"),
    (4, 100, 70, torch.float32, None, dict(bias="full", activation="tanh"),
     1e-5, "decode"),
    (8, 640, 96, torch.int8, torch.int32, {}, 0.0, "decode"),
    (3, 1000, 130, torch.float16, None, dict(
        glu=True, activation="gelu", bias="row", has_scale_a=True,
        has_scale_b=True), 3e-2, "decode"),
    # bf16 with K not a multiple of 8: TMA refuses the rows, SIMT serves
    (70, 100, 128, torch.bfloat16, None, dict(activation="silu"), 3e-2,
     "simt"),
    # fp8 e4m3fn and e5m2, read a byte an element, fp32 out: the decode
    # tile (K split, GLU, ragged N) and the SIMT tile (every epilogue
    # field, ragged edges); the reference's tolerance
    (4, 4096, 22016, torch.float8_e4m3fn, None, dict(
        glu=True, activation="silu"), 3e-2, "decode"),
    (4, 4096, 22016, torch.float8_e5m2, None, dict(
        glu=True, activation="silu"), 3e-2, "decode"),
    (1, 40, 27, torch.float8_e5m2, None, dict(activation="relu"), 3e-2,
     "decode"),
    (200, 520, 304, torch.float8_e4m3fn, None, dict(
        glu=True, activation="silu", has_residual=True), 3e-2, "simt"),
    (70, 96, 130, torch.float8_e5m2, None, dict(
        bias="full", activation="gelu", has_scale_a=True, has_scale_b=True,
        softcap=5.0), 3e-2, "simt"),
]
FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def _mm_case(card, m, k, n, dt, out_dt, fields):
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
                  out_dtype=out_dt or (torch.float32 if dt in (
                      torch.int8,) + FP8 else dt), **fields)
    return a, b, ep, ops


@pytest.mark.parametrize("case", MM_CASES, ids=lambda c: f"{c[0]}x{c[1]}x"
                         f"{c[2]}-{str(c[3])[6:]}-{'-'.join(c[5]) or 'plain'}")
def test_fused_matmul_kernel_vs_plain(card, case):
    m, k, n, dt, out_dt, fields, tol, tile = case
    a, b, ep, ops = _mm_case(card, m, k, n, dt, out_dt, fields)
    before = mm_ops.fused_matmul.launches
    by_tile = dict(mm_ops.fused_matmul.launches_by_tile)
    out = mm_ops.fused_matmul(a, b, epilogue=ep, operands=ops)
    assert mm_ops.fused_matmul.launches == before + 1
    by_tile[tile] += 1
    assert mm_ops.fused_matmul.launches_by_tile == by_tile
    ref = fused_matmul_plain(a, b, ep, ops, torch.int32 if dt == torch.int8
                             else torch.float32)
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype and out.shape == ref.shape
    if dt == torch.int8 and out_dt == torch.int32:
        assert torch.equal(out, ref)
    assert _rel(out, ref) <= tol


@pytest.mark.parametrize("tile,m", [("decode", 4), ("tc", 884)])
def test_fused_matmul_tile_repeats_bit_for_bit(card, tile, m):
    """No atomics: the same call gives the same bits twice, on the tile
    the count names."""
    a, b, ep, ops = _mm_case(card, m, 4096, 2 * 1024, torch.bfloat16, None,
                             dict(glu=True, activation="silu"))
    before = mm_ops.fused_matmul.launches_by_tile[tile]
    one = mm_ops.fused_matmul(a, b, epilogue=ep, operands=ops)
    two = mm_ops.fused_matmul(a, b, epilogue=ep, operands=ops)
    torch.cuda.synchronize()
    assert mm_ops.fused_matmul.launches_by_tile[tile] == before + 2
    assert torch.equal(one, two)


@pytest.mark.parametrize("m", [2, 9], ids=["decode", "simt"])
@pytest.mark.parametrize("dt", FP8, ids=lambda v: str(v)[6:])
def test_fused_matmul_kernel_decodes_every_fp8_code(card, dt, m):
    """A K = 1 product by 1.0 gives B's values as cuda_fp8.h decoded them
    in the tile: all 256 codes of each format (subnormals, zeros, e5m2's
    infinities, the NaNs) equal torch's decoding; fp32 out by default,
    as the fp8 policy writes."""
    a = torch.ones(m, 1, device="cuda").to(dt)
    b = torch.arange(256, dtype=torch.uint8, device="cuda").view(
        dt).reshape(1, 256)
    out = mm_ops.fused_matmul(a, b)
    torch.cuda.synchronize()
    want = b.float().expand(m, 256)
    assert out.dtype == torch.float32
    assert torch.equal(out.isnan(), want.isnan())
    ok = ~want.isnan()
    assert torch.equal(out[ok], want[ok])


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


INT8_ATTN_CASES = [  # (b, h, hkv, sq, sk, d, flags)
    (4, 32, 32, 221, 221, 128, dict(causal=True)),
    (2, 4, 1, 33, 100, 64, dict(causal=True, window=16, q_start=40)),
    (2, 4, 4, 32, 32, 16, dict(causal=True)),
]


def _int8_qkv(card, b, h, hkv, sq, sk, d):
    q = torch.randint(-8, 9, (b, h, sq, d), generator=card, device="cuda",
                      dtype=torch.int8)
    k, v = (torch.randint(-127, 128, (b, hkv, sk, d), generator=card,
                          device="cuda", dtype=torch.int8)
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("case", INT8_ATTN_CASES,
                         ids=lambda c: f"q{c[3]}k{c[4]}d{c[5]}")
def test_flash_attention_kernel_int8(card, case):
    """int8 q, k, v on the SIMT tile, the output truncated toward zero
    into int8: within 1 of the plain version at every element."""
    b, h, hkv, sq, sk, d, flags = case
    q, k, v = _int8_qkv(card, b, h, hkv, sq, sk, d)
    before = attn_ops.flash_attention.launches_by_tile["simt"]
    out = attn_ops.flash_attention(q, k, v, **flags)
    assert attn_ops.flash_attention.launches_by_tile["simt"] == before + 1
    kw = dict(sm_scale=d ** -0.5, window=0, softcap=0.0, q_start=0) | flags
    ref = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert out.dtype == torch.int8 and out.shape == ref.shape
    assert (out.int() - ref.int()).abs().max().item() <= 1


def test_paged_flash_attention_int8_bit_exact(card):
    """int8 pages under a shuffled block table through K2 equal the
    contiguous call bit for bit (the reference's int8 paged flash route)."""
    from repro_torch.kernels.attention.paged import (paged_flash_attention,
                                                     to_paged)
    q, k, v = _int8_qkv(card, 2, 4, 4, 32, 32, 16)
    ref = attn_ops.flash_attention(q, k, v)
    for block_tokens in (8, 16):
        kp, vp, table = to_paged(k, v, block_tokens, seed=5)
        got = paged_flash_attention(q, kp, vp, table, seq_len=32)
        torch.cuda.synchronize()
        assert got.dtype == torch.int8 and torch.equal(got, ref)


def test_flash_attention_fully_masked_rows_are_zero(card):
    q = torch.randn(1, 2, 8, 32, generator=card, device="cuda")
    k, v = (torch.randn(1, 1, 40, 32, generator=card, device="cuda")
            for _ in range(2))
    out = attn_ops.flash_attention(q, k, v, causal=True, window=4,
                                   q_start=100)
    assert torch.equal(out, torch.zeros_like(out))


TC_ATTN_CASES = [  # (b, h, hkv, sq, sk, d, dtype, flags, transposed)
    # the served paths: yi-6b GQA 32/4, OLMoE 16/16 (both d=128), and
    # RecurrentGemma MQA 10/1 at d=256 with its window, on the views
    # qkv_project passes
    (4, 32, 4, 221, 221, 128, torch.bfloat16, dict(causal=True), False),
    (4, 32, 4, 90, 90, 128, torch.bfloat16, dict(causal=True), True),
    (4, 16, 16, 221, 221, 128, torch.bfloat16, dict(causal=True), True),
    (4, 10, 1, 221, 221, 256, torch.bfloat16,
     dict(causal=True, window=2048), True),
    # ragged Sq and Sk, one query, non-causal, softcap, windows that cut
    # inside a key tile, q_start with Sq < Sk, fp16, d = 64
    (2, 4, 2, 1, 1, 64, torch.float16, dict(causal=True), False),
    (2, 4, 2, 63, 100, 64, torch.bfloat16, dict(causal=False), False),
    (2, 4, 2, 65, 65, 128, torch.float16, dict(causal=True, softcap=50.0),
     False),
    (1, 8, 2, 300, 300, 128, torch.bfloat16, dict(causal=True, window=37),
     True),
    (2, 4, 1, 50, 300, 128, torch.bfloat16,
     dict(causal=True, q_start=250, window=64), False),
    (2, 10, 1, 130, 70, 256, torch.float16,
     dict(causal=False, softcap=30.0), True),
    (1, 4, 4, 200, 200, 256, torch.bfloat16,
     dict(causal=True, window=100, q_start=5), False),
]


def _attn_inputs(card, b, h, hkv, sq, sk, d, dt, transposed):
    """q, k, v; ``transposed``: (B, S, heads, D) memory seen as
    (B, heads, S, D), as the models pass them."""
    def one(n, s):
        if transposed:
            return torch.randn(b, s, n, d, generator=card,
                               device="cuda").to(dt).transpose(1, 2)
        return torch.randn(b, n, s, d, generator=card, device="cuda").to(dt)
    return one(h, sq), one(hkv, sk), one(hkv, sk)


@pytest.mark.parametrize("case", TC_ATTN_CASES, ids=lambda c: (
    f"b{c[0]}h{c[1]}kv{c[2]}q{c[3]}k{c[4]}d{c[5]}-{str(c[6])[6:]}-"
    + "-".join(f"{k}{v}" for k, v in c[7].items()) + "-T" * c[8]))
def test_flash_attention_tc_tile_vs_plain(card, case):
    """K2's tensor-core tile against the plain version, row by row within
    2e-2 (a 16-bit output's rounding step is up to 7.8e-3 of its row's
    max, and P is rounded to q's dtype before P V, which the plain
    version does not do), bit-identical on a second run (no atomics), one
    launch counted on the tile."""
    b, h, hkv, sq, sk, d, dt, flags, transposed = case
    q, k, v = _attn_inputs(card, b, h, hkv, sq, sk, d, dt, transposed)
    before = dict(attn_ops.flash_attention.launches_by_tile)
    out = attn_ops.flash_attention(q, k, v, **flags)
    assert attn_ops.flash_attention.launches_by_tile == {
        **before, "tc": before["tc"] + 1}
    kw = dict(sm_scale=d ** -0.5, window=0, softcap=0.0, q_start=0) | flags
    ref = flash_attention_plain(q, k, v, **kw)
    again = attn_ops.flash_attention(q, k, v, **flags)
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert bool(torch.isfinite(out).all())
    assert _row_rel(out, ref) <= 2e-2
    assert torch.equal(out, again)


@pytest.mark.parametrize("d", [128, 256])
def test_flash_attention_tc_tile_fully_masked_rows_are_zero(card, d):
    """Queries at 20..159 with a window of 4 against 40 keys: those at 43
    and on see none and give bf16 zeros exactly, not NaN, both beside rows
    that see keys (the first query tile) and in a tile that sees none."""
    q = torch.randn(1, 2, 140, d, generator=card, device="cuda").to(
        torch.bfloat16)
    k, v = (torch.randn(1, 1, 40, d, generator=card, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    kw = dict(causal=True, window=4, q_start=20)
    before = attn_ops.flash_attention.launches_by_tile["tc"]
    out = attn_ops.flash_attention(q, k, v, **kw)
    assert attn_ops.flash_attention.launches_by_tile["tc"] == before + 1
    ref = flash_attention_plain(q, k, v, sm_scale=d ** -0.5, softcap=0.0,
                                **kw)
    torch.cuda.synchronize()
    assert torch.equal(out[:, :, 23:], torch.zeros_like(out[:, :, 23:]))
    assert bool((out[:, :, :23] != 0).any())
    assert _row_rel(out, ref) <= 2e-2


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


GM_CASES = [  # (e, c, k, n, dtype, epilogue fields, tol, tile, rows,
    #             max_rows, max_experts)
    (5, 33, 72, 200, torch.float32, dict(glu=True, activation="gelu"), 1e-5,
     "simt", None, None, None),
    (3, 70, 96, 130, torch.float16, {}, 3e-2, "simt", None, None, None),
    (3, 9, 100, 70, torch.int8, {}, 0.0, "simt", None, None, None),
    (3, 70, 64, 48, torch.int8, {}, 0.0, "simt", [0, 64, 70], None, None),
    # tensor-core tile: C = 9, 70, 144 and 200 (64-row tiles at 9, 128-row
    # at 70 and 200, 192-row at 144), ragged C, K not a multiple of 64, GLU silu,
    # bf16 and fp16, with and without rows (an empty expert, a skipped
    # row tile, a partial last one)
    (4, 9, 520, 256, torch.bfloat16, dict(glu=True, activation="silu"),
     3e-2, "tc", None, None, None),
    (3, 70, 200, 384, torch.float16, dict(glu=True, activation="silu"),
     3e-2, "tc", None, None, None),
    (8, 144, 2048, 512, torch.bfloat16, dict(glu=True, activation="silu"),
     3e-2, "tc", None, None, None),
    (3, 200, 136, 200, torch.float16, dict(activation="relu2", softcap=5.0),
     3e-2, "tc", None, None, None),
    (4, 144, 520, 256, torch.bfloat16, dict(glu=True, activation="silu"),
     3e-2, "tc", [0, 64, 100, 144], None, None),
    (3, 200, 1000, 128, torch.float16, {}, 3e-2, "tc", [129, 0, 200], None,
     None),
    # decode tile: C = 1, 4 and 8, with and without rows, K split across
    # blocks where the experts give too few (all but the 100-deep case)
    (4, 8, 256, 512, torch.bfloat16, dict(glu=True, activation="silu"),
     3e-2, "decode", None, None, None),
    (6, 1, 2048, 512, torch.bfloat16, dict(glu=True, activation="silu"),
     3e-2, "decode", None, None, None),
    (6, 1, 2048, 512, torch.bfloat16, dict(glu=True, activation="silu"),
     3e-2, "decode", [1, 0, 0, 1, 0, 1], 1, 3),
    (6, 4, 2048, 512, torch.bfloat16, dict(glu=True, activation="silu"),
     3e-2, "decode", [4, 0, 1, 0, 3, 2], None, None),
    (6, 8, 1024, 2048, torch.bfloat16, {}, 3e-2, "decode",
     [4, 0, 0, 4, 1, 0], 4, 3),
    (5, 4, 100, 130, torch.float32, dict(activation="tanh"), 1e-5, "decode",
     [2, 0, 0, 4, 1], None, None),
    (5, 8, 640, 96, torch.int8, {}, 0.0, "decode", [0, 8, 3, 0, 1], None,
     None),
    # fp8, fp32 out: OLMoE's prefill GLU shape on the SIMT tile (with a
    # routing's rows), and its decode capacity on the decode tile
    (4, 144, 2048, 2048, torch.float8_e4m3fn, dict(glu=True,
                                                  activation="silu"), 3e-2,
     "simt", [144, 0, 3, 77], None, None),
    (6, 8, 2048, 512, torch.float8_e5m2, dict(glu=True, activation="silu"),
     3e-2, "decode", [4, 0, 1, 0, 3, 2], 4, 3),
    (3, 8, 1024, 2048, torch.float8_e4m3fn, {}, 3e-2, "decode", None, None,
     None),
]


def _gm_case(card, e, c, k, n, dt, fields, rows=None, tile=None):
    """Inputs of one K4 case; with ``rows``, x is zero from rows[e] on in
    ``x_ref`` and NaN (127 in int8) in ``x`` wherever no block of ``tile``
    may load it (rows at or past rows[e] on the decode tile, whole row
    tiles at or past it on the others)."""
    if dt == torch.int8:
        x = torch.randint(-127, 128, (e, c, k), generator=card,
                          device="cuda", dtype=dt)
        w = torch.randint(-127, 128, (e, k, n), generator=card,
                          device="cuda", dtype=dt)
    else:
        x = torch.randn(e, c, k, generator=card, device="cuda").to(dt)
        w = (torch.randn(e, k, n, generator=card, device="cuda")
             / k ** .5).to(dt)
    x_ref = x.clone()
    if rows is not None:
        # the tensor-core tile's rows (grouped_matmul_sm90.cu): of 64, 128
        # and 192, the tallest of those that compute the fewest rows
        tc_bm = min((-(-c // bm) * bm, -bm) for bm in (64, 128, 192))[1]
        bm = {"decode": 1, "simt": 64, "tc": -tc_bm}[tile]
        for i, r in enumerate(rows):
            x_ref[i, r:] = 0
            skip = -(-r // bm) * bm
            x[i, :skip] = x_ref[i, :skip]
            x[i, skip:] = 127 if dt == torch.int8 else float("nan")
        rows = torch.tensor(rows, dtype=torch.int32, device="cuda")
    int8 = dt == torch.int8
    ep = Epilogue(out_dtype=torch.int32 if int8 else torch.float32
                  if dt in FP8 else dt, **fields)
    return x, x_ref, w, ep, rows


@pytest.mark.parametrize("case", GM_CASES, ids=lambda c: f"{c[0]}x{c[1]}x"
                         f"{c[2]}x{c[3]}-{str(c[4])[6:]}-{c[7]}"
                         f"{'-rows' if c[8] else ''}")
def test_grouped_matmul_kernel_vs_plain(card, case):
    e, c, k, n, dt, fields, tol, tile, rows, max_rows, max_experts = case
    x, x_ref, w, ep, rows = _gm_case(card, e, c, k, n, dt, fields, rows,
                                     tile)
    before = gm_ops.grouped_matmul.launches
    by_tile = dict(gm_ops.grouped_matmul.launches_by_tile)
    out = gm_ops.grouped_matmul(x, w, epilogue=ep, rows=rows,
                                max_rows=max_rows, max_experts=max_experts)
    assert gm_ops.grouped_matmul.launches == before + 1
    by_tile[tile] += 1
    assert gm_ops.grouped_matmul.launches_by_tile == by_tile
    int8 = dt == torch.int8
    ref = grouped_matmul_plain(x_ref, w, ep,
                               torch.int32 if int8 else torch.float32)
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype and out.shape == ref.shape
    if int8:
        assert torch.equal(out, ref)
    for i in range(e):              # every expert on its own scale
        assert _rel(out[i], ref[i]) <= tol


@pytest.mark.parametrize("tile,c,rows", [
    ("tc", 144, None), ("tc", 144, [144, 0, 3, 77]),
    ("decode", 8, None), ("decode", 8, [4, 0, 1, 3])])
def test_grouped_matmul_tile_repeats_bit_for_bit(card, tile, c, rows):
    """No atomics: the same call gives the same bits twice, on the tile
    the count names (the decode case splits K)."""
    x, _, w, ep, rows = _gm_case(card, 4, c, 2048, 2 * 512, torch.bfloat16,
                                 dict(glu=True, activation="silu"), rows,
                                 tile)
    before = gm_ops.grouped_matmul.launches_by_tile[tile]
    one = gm_ops.grouped_matmul(x, w, epilogue=ep, rows=rows)
    two = gm_ops.grouped_matmul(x, w, epilogue=ep, rows=rows)
    torch.cuda.synchronize()
    assert gm_ops.grouped_matmul.launches_by_tile[tile] == before + 2
    assert torch.equal(one, two)


# the register path (rows of whole 16-byte vectors, at most 16 x 768
# elements, from an aligned base) at the W8A8 path's shapes, and the loop
# path (ragged K, K past the register limit)
@pytest.mark.parametrize("m,k,dt", [(37, 200, torch.float32),
                                    (64, 4096, torch.bfloat16),
                                    (5, 300, torch.float16),
                                    (884, 4096, torch.float32),
                                    (884, 4096, torch.bfloat16),
                                    (884, 11008, torch.float32),
                                    (37, 201, torch.float32),
                                    (3, 16400, torch.float32)],
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


@pytest.mark.parametrize("b,t,c,h0", [(4, 221, 2560, True),
                                      (4, 90, 2560, True), (3, 37, 300, True),
                                      (3, 40, 17, False), (2, 1, 64, False)])
def test_rglru_scan_kernel_bit_identical(card, b, t, c, h0):
    """Each channel's chain in one thread, in time order, with the plain
    version's roundings: h and h_T equal it bit for bit, at the prefill
    passes' shapes (log_a as the recurrent block makes it) and ragged."""
    lam = torch.rand(c, generator=card, device="cuda") * 4.0 + 2.0
    gate = torch.sigmoid(torch.randn(b, t, c, generator=card, device="cuda"))
    log_a = -8.0 * torch.nn.functional.softplus(lam) * gate
    x = torch.randn(b, t, c, generator=card, device="cuda")
    init = torch.randn(b, c, generator=card, device="cuda") if h0 else None
    h, h_last = rg_ops.rglru_scan(log_a, x, init)
    ref, ref_last = rglru_scan_plain(log_a, x, init)
    torch.cuda.synchronize()
    assert torch.equal(h, ref) and torch.equal(h_last, ref_last)


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


WKV_TC_CASES = [  # (b, h, t, chunk, dtype, initial state, lw, transposed)
    (4, 64, 221, 64, torch.bfloat16, True, None, False),   # the served call
    (4, 64, 221, 64, torch.float16, True, None, False),
    (4, 64, 221, 32, torch.bfloat16, False, None, False),  # ``forward``'s
    (2, 8, 100, 64, torch.float16, True, None, False),
    (2, 8, 5, 32, torch.bfloat16, True, None, False),
    (2, 8, 100, 64, torch.bfloat16, True, None, True),     # the model's views
    (2, 8, 221, 64, torch.bfloat16, False, -403.4287934927351, False),
    (2, 8, 221, 64, torch.bfloat16, False, -3.354626279025119e-4, False),
]


def _wkv_inputs(card, b, h, t, dt, with_s0, lw_value, transposed, c=64):
    """r, k, v in ``dt``; lw = -exp(clip(w, -8, 6)) as the model makes it
    (or the constant ``lw_value``); ``transposed``: (B, T, H, C) memory
    seen as (B, H, T, C), as ``time_mix`` passes them."""
    shape = (b, t, h, c) if transposed else (b, h, t, c)

    def view(x):
        return x.transpose(1, 2) if transposed else x
    r, k, v = (view(torch.randn(shape, generator=card, device="cuda").to(dt))
               for _ in range(3))
    if lw_value is None:
        w = torch.randn(shape, generator=card, device="cuda") * 1.5 - 1.0
        lw = view(-torch.exp(w.clamp(-8.0, 6.0)))
    else:
        lw = view(torch.full(shape, lw_value, device="cuda"))
    u = torch.randn(h, c, generator=card, device="cuda") * 0.3
    s0 = (torch.randn(b, h, c, c, generator=card, device="cuda") * 0.3
          if with_s0 else None)
    return r, k, v, lw, u, s0


@pytest.mark.parametrize("case", WKV_TC_CASES, ids=lambda c: (
    f"b{c[0]}h{c[1]}t{c[2]}L{c[3]}-{str(c[4])[6:]}" + "-s0" * c[5]
    + (f"-lw{c[6]:.3g}" if c[6] is not None else "") + "-T" * c[7]))
def test_rwkv6_wkv_tc_tile_vs_plain(card, case):
    """K6's tensor-core tile against the plain version: the output within
    3e-2 over the whole tensor and row by row (each token's row against
    its own max |ref|: operands and P are rounded to 16 bits), the fp32
    state within 1e-4, every value finite at the decay limits,
    bit-identical on a second run (no atomics), one launch counted on
    the tile."""
    b, h, t, chunk, dt, with_s0, lw_value, transposed = case
    r, k, v, lw, u, s0 = _wkv_inputs(card, b, h, t, dt, with_s0, lw_value,
                                     transposed)
    before = dict(wkv_ops.rwkv6_scan.launches_by_tile)
    o, s = wkv_ops.rwkv6_scan(r, k, v, lw, u, chunk=chunk, initial_state=s0)
    assert wkv_ops.rwkv6_scan.launches_by_tile == {
        **before, "tc": before["tc"] + 1}
    ref, ref_s = rwkv6_chunked(r, k, v, lw, u, chunk=chunk, initial_state=s0)
    o2, s2 = wkv_ops.rwkv6_scan(r, k, v, lw, u, chunk=chunk,
                                initial_state=s0)
    torch.cuda.synchronize()
    assert o.dtype == ref.dtype == dt and o.shape == ref.shape
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(s).all())
    assert _rel(o, ref) <= 3e-2 and _row_rel(o, ref) <= 3e-2
    assert _rel(s, ref_s) <= 1e-4
    assert torch.equal(o, o2) and torch.equal(s, s2)


def test_rwkv6_wkv_tc_tile_carries_the_state(card):
    """Two calls with the state carried give one call's output (within
    3e-2, row by row) and final state (within 1e-4), on the tile."""
    r, k, v, lw, u, _ = _wkv_inputs(card, 4, 64, 221, torch.bfloat16, False,
                                    None, False)
    before = wkv_ops.rwkv6_scan.launches_by_tile["tc"]
    o, s = wkv_ops.rwkv6_scan(r, k, v, lw, u, chunk=64)
    cut = 110
    o1, s1 = wkv_ops.rwkv6_scan(*(x[:, :, :cut] for x in (r, k, v, lw)), u,
                                chunk=64)
    o2, s2 = wkv_ops.rwkv6_scan(*(x[:, :, cut:] for x in (r, k, v, lw)), u,
                                chunk=64, initial_state=s1)
    torch.cuda.synchronize()
    assert wkv_ops.rwkv6_scan.launches_by_tile["tc"] == before + 3
    both = torch.cat([o1, o2], dim=2)
    assert _rel(both, o) <= 3e-2 and _row_rel(both, o) <= 3e-2
    assert _rel(s2, s) <= 1e-4


def _in_fresh_thread(fn):
    """``fn()`` on a new ``threading.Thread`` that never set its device;
    returns its result or raises what it raised."""
    import threading
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:          # re-raised on the caller
            box["err"] = e
    t = threading.Thread(target=run)
    t.start()
    t.join()
    if "err" in box:
        raise box["err"]
    return box["out"]


@pytest.mark.parametrize("kernel", ["fused_matmul", "grouped_matmul",
                                    "flash_attention", "rwkv6_wkv"])
def test_tc_tile_launches_from_a_fresh_thread(card, kernel):
    """Each tensor-core tile (K1, K4, K2, K6) launched from a thread that
    never called ``torch.cuda.set_device``: the launcher binds the card
    itself (``kernels.bind_device``), so the launch succeeds on the tc
    tile and agrees with the plain version."""
    if kernel == "fused_matmul":
        a, b, ep, ops = _mm_case(card, 256, 512, 1024, torch.bfloat16, None,
                                 dict(glu=True, activation="silu"))
        wrapper = mm_ops.fused_matmul
        run = lambda: wrapper(a, b, epilogue=ep, operands=ops)   # noqa: E731
        ref = fused_matmul_plain(a, b, ep, ops, torch.float32)
        tol, rel = 3e-2, _rel
    elif kernel == "grouped_matmul":
        x, x_ref, w, ep, _ = _gm_case(card, 4, 144, 256, 512, torch.bfloat16,
                                      dict(glu=True, activation="silu"))
        wrapper = gm_ops.grouped_matmul
        run = lambda: wrapper(x, w, epilogue=ep)                 # noqa: E731
        ref = grouped_matmul_plain(x_ref, w, ep, torch.float32)
        tol, rel = 3e-2, _rel
    elif kernel == "flash_attention":
        q, k, v = _attn_inputs(card, 2, 4, 2, 128, 128, 128, torch.bfloat16,
                               False)
        wrapper = attn_ops.flash_attention
        run = lambda: wrapper(q, k, v, causal=True)              # noqa: E731
        ref = flash_attention_plain(q, k, v, sm_scale=128 ** -0.5,
                                    causal=True, window=0, softcap=0.0,
                                    q_start=0)
        tol, rel = 2e-2, _row_rel
    else:
        r, k, v, lw, u, s0 = _wkv_inputs(card, 2, 4, 100, torch.bfloat16,
                                         True, None, False)
        wrapper = wkv_ops.rwkv6_scan
        run = lambda: wrapper(r, k, v, lw, u, chunk=64,          # noqa: E731
                              initial_state=s0)[0]
        ref = rwkv6_chunked(r, k, v, lw, u, chunk=64, initial_state=s0)[0]
        tol, rel = 3e-2, _row_rel
    before = wrapper.launches_by_tile["tc"]
    out = _in_fresh_thread(run)
    torch.cuda.synchronize()
    assert wrapper.launches_by_tile["tc"] == before + 1
    assert out.shape == ref.shape and bool(torch.isfinite(out).all())
    assert rel(out, ref) <= tol
