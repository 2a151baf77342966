"""K6's tile rule (``kernels/rwkv6/rwkv6.py::select_tile``) on the served
dtype, head size, chunks and the model's strides; the CPU wrapper, which
runs the plain version whatever the rule would pick on a card; the
tensor-core tile's launch plumbing (its strides, its output layout, the
count by tile); and the tensor-core tile's arithmetic written in plain
ops (``rwkv6_chunked_tc``: sub-chunk reference points, operands rounded
to 16 bits, the hi/lo state update) against the JAX package's
``rwkv6_ref`` and ``rwkv6_chunked_jnp``.  The tiles themselves run only
on the card (tests/test_torch_kernels_cuda.py) and, the SIMT tile, in the
g++ emulation (tests/test_torch_kernels_emulated.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.rwkv6.ref import rwkv6_ref as j_ref      # noqa: E402
from repro.models.rwkv6 import rwkv6_chunked_jnp             # noqa: E402
from repro_torch.configs.registry import get_config          # noqa: E402
from repro_torch.kernels.rwkv6 import ops                    # noqa: E402
from repro_torch.kernels.rwkv6 import rwkv6 as wkv           # noqa: E402
from repro_torch.models import rwkv6 as rw                   # noqa: E402

bf16, fp16, f32 = torch.bfloat16, torch.float16, torch.float32
# byte strides along B, H and T of RWKV-6-7B's r (bf16) and lw (fp32) at
# a 221-token prefill: (B, T, H * 64) memory seen as (B, H, T, 64)
SERVED = [221 * 4096 * 2, 128, 8192] * 3 + [221 * 4096 * 4, 256, 16384]


@pytest.mark.parametrize("case,tile", [
    ((bf16, 64, 64, True, SERVED), "tc"),          # the served prefill
    ((bf16, 64, 32, True, SERVED), "tc"),          # ``forward``'s chunk
    ((fp16, 64, 64, True, SERVED), "tc"),
    ((bf16, 64, 64, True, [64 * 100 * 2, 64 * 2, 128]), "tc"),  # contiguous
    ((bf16, 64, 64, True, []), "tc"),              # every dim of length 1
    ((f32, 64, 64, True, SERVED), "simt"),         # fp32 stays off the MMAs
    ((bf16, 32, 64, True, [64]), "simt"),          # head sizes it lacks
    ((bf16, 128, 64, True, [256]), "simt"),
    ((bf16, 64, 16, True, SERVED), "simt"),        # a chunk it lacks
    ((bf16, 64, 64, False, SERVED), "simt"),       # unaligned, or C-strided
    ((bf16, 64, 64, True, [128, 136]), "simt"),    # stride % 16 bytes
    ((bf16, 64, 64, True, [128, 0]), "simt"),      # an expanded dim
    ((bf16, 64, 64, True, [128, -128]), "simt"),   # a flipped dim
], ids=lambda v: "-".join(map(str, v[:4])).replace("torch.", "")
    if isinstance(v, tuple) else v)
def test_select_tile_rule(case, tile):
    assert wkv.select_tile(*case) == tile


def _served_wkv_args(dtype=bf16, seq=5):
    """The r, k, v, lw, u that ``time_mix`` hands the WKV at prefill, for
    the reduced RWKV-6 at the served head size (64)."""
    cfg = get_config("rwkv6-7b", reduced=True)
    cfg = cfg.with_(rwkv=dataclasses.replace(cfg.rwkv, head_size=64),
                    n_heads=cfg.d_model // 64, dtype=dtype,
                    kv_cache_dtype=dtype, backend="kernel")
    params = rw.init(cfg, torch.Generator().manual_seed(0))
    layer = {name: x[0] for name, x in params["layers"].items()}
    x = torch.randn(2, seq, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)).to(dtype)
    seen = []

    def record(r, k, v, lw, u, *, chunk, initial_state=None):
        seen.append((r, k, v, lw, u, chunk))
        return wkv.rwkv6_chunked(r, k, v, lw, u, chunk=chunk,
                                 initial_state=initial_state)
    state = torch.zeros(2, cfg.n_heads, 64, 64)
    real = ops.rwkv6_scan
    ops.rwkv6_scan = record
    try:
        rw.time_mix(cfg, layer, x, wkv_state=state)
    finally:
        ops.rwkv6_scan = real
    (r, k, v, lw, u, chunk), = seen
    return r, k, v, lw, u, chunk


@pytest.mark.parametrize("dtype,tile", [(bf16, "tc"), (fp16, "tc"),
                                        (f32, "simt")],
                         ids=["bf16", "fp16", "fp32"])
def test_the_served_prefill_takes_the_tensor_core_tile(dtype, tile):
    """``time_mix``'s prefill call (chunk 64, with the carried state) on
    the views it passes, with no copy: (B, T, H, 64) projections seen as
    (B, H, T, 64); the same call in fp32 takes the SIMT tile."""
    r, k, v, lw, u, chunk = _served_wkv_args(dtype)
    assert chunk == 64 and r.shape[-1] == 64
    assert lw.dtype == f32 and r.dtype == dtype
    assert not r.is_contiguous() and r.stride()[2] == r.shape[1] * 64
    assert wkv.tile_for(r, k, v, lw, chunk=chunk) == tile
    assert wkv.tile_for(r, k, v, lw, chunk=32) == tile


def test_tile_for_reads_views():
    """``tile_for`` reads pointers and strides, ignoring those of dims of
    length 1; an unaligned base, an odd stride, an expanded dim or a
    strided head dim takes the SIMT tile."""
    g = torch.Generator().manual_seed(1)
    base = torch.randn(8 + 2 * 3 * 10 * 64, generator=g).to(bf16)
    x = base[:-8].view(2, 3, 10, 64)
    lw = -torch.rand(2, 3, 10, 64, generator=g)
    assert wkv.tile_for(x, x, x, lw, chunk=64) == "tc"
    shifted = base[1:-7].view(2, 3, 10, 64)              # 2 bytes off
    assert wkv.tile_for(shifted, x, x, lw, chunk=64) == "simt"
    odd = torch.randn(2, 3, 10, 68, generator=g).to(bf16)[..., :64]
    assert wkv.tile_for(x, odd, x, lw, chunk=64) == "simt"
    expanded = x[:, :1].expand(2, 3, 10, 64)
    assert wkv.tile_for(x, x, expanded, lw, chunk=64) == "simt"
    strided = torch.randn(2, 3, 10, 128, generator=g).to(bf16)[..., ::2]
    assert wkv.tile_for(strided, x, x, lw, chunk=64) == "simt"
    one = torch.as_strided(x, (1, 1, 10, 64), (7, 3, 64, 1))
    lw1 = lw[:1, :1]
    assert wkv.tile_for(one, one, one, lw1, chunk=64) == "tc"


@pytest.mark.parametrize("dt", [bf16, f32], ids=["bf16", "fp32"])
def test_cpu_wrapper_runs_the_plain_version(dt):
    """On CPU tensors the wrapper runs the plain version, whichever tile
    the rule would pick on a card, and counts no launch."""
    r, k, v, lw, u, chunk = _served_wkv_args(dt, seq=40)
    s0 = torch.randn(2, r.shape[1], 64, 64,
                     generator=torch.Generator().manual_seed(3))
    before = (ops.rwkv6_scan.launches, dict(ops.rwkv6_scan.launches_by_tile))
    o, s = ops.rwkv6_scan(r, k, v, lw, u, chunk=chunk, initial_state=s0)
    ref, ref_s = wkv.rwkv6_chunked(r, k, v, lw, u, chunk=chunk,
                                   initial_state=s0)
    assert torch.equal(o, ref) and torch.equal(s, ref_s)
    assert (ops.rwkv6_scan.launches,
            ops.rwkv6_scan.launches_by_tile) == before
    assert set(ops.rwkv6_scan.launches_by_tile) == set(wkv.TILES)


def test_tc_launch_passes_the_views_and_writes_o_in_model_order(
        monkeypatch):
    """The tensor-core tile gets r, k, v and lw as they lie (no copy) with
    their element strides, writes o in (B, T, H, C) memory and returns its
    (B, H, T, C) view, which ``o.transpose(1, 2).reshape(b, t, d)`` reads
    without a copy; the count goes to the tile that launched."""
    r, k, v, lw, u, chunk = _served_wkv_args(bf16, seq=7)
    calls = []

    def fake(dtype, rp, kp, vp, lwp, up, s0p, op, sp, b, h, t, L, st, s):
        calls.append(dict(ptrs=(rp, kp, vp, lwp), b=b, h=h, t=t, L=L,
                          strides=list(st[:15]), o=op))
        return 0
    monkeypatch.setattr(wkv, "_tc_launcher", lambda: fake)

    class _Stream:
        cuda_stream = None
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    o, s, tile = wkv.rwkv6_wkv_cuda(r, k, v, lw, u, chunk=chunk)
    assert tile == "tc"
    (call,) = calls
    assert call["ptrs"] == tuple(x.data_ptr() for x in (r, k, v, lw))
    assert (call["b"], call["h"], call["t"], call["L"]) == (2, r.shape[1],
                                                            7, 64)
    assert call["strides"] == [st for x in (r, k, v, lw, o)
                               for st in x.stride()[:3]]
    assert call["o"] == o.data_ptr() and o.shape == r.shape
    assert o.transpose(1, 2).is_contiguous()
    assert s.shape == (2, r.shape[1], 64, 64) and s.dtype == f32

    class _FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True
    monkeypatch.setattr(ops, "rwkv6_wkv_cuda",
                        lambda *a, **kw: (o, s, "tc"))
    before = dict(ops.rwkv6_scan.launches_by_tile)
    ops.rwkv6_scan(torch.Tensor._make_subclass(_FakeCuda, r), k, v, lw, u,
                   chunk=64)
    assert ops.rwkv6_scan.launches_by_tile == {**before,
                                               "tc": before["tc"] + 1}


def test_a_failed_tc_launch_raises(monkeypatch):
    r, k, v, lw, u, chunk = _served_wkv_args(bf16, seq=3)
    monkeypatch.setattr(wkv, "_tc_launcher", lambda: lambda *a: 700)

    class _Stream:
        cuda_stream = None
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    with pytest.raises(RuntimeError, match=r"\(tc tile\): CUDA error 700"):
        wkv.rwkv6_wkv_cuda(r, k, v, lw, u, chunk=chunk)


# ---------------------------------------------------------------------------
# The tensor-core tile's arithmetic against the JAX package.
# ---------------------------------------------------------------------------

def _inputs(b=2, h=3, t=100, c=64, seed=0, dtype=None, lw_value=None,
            mild=False):
    """numpy-seeded r, k, v (rounded to ``dtype`` where given, as the
    tile receives them), lw = -exp(clip(w, -8, 6)) with w ~ 1.5 N - 1 as
    the model makes it, or -exp(0.5 N) (``mild``, as
    tests/test_torch_rwkv6.py draws it), or the constant ``lw_value``; u
    and an initial state; all fp32."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, h, t, c)).astype(np.float32)
               for _ in range(3))
    if dtype is not None:
        r, k, v = (torch.from_numpy(x).to(dtype).float().numpy()
                   for x in (r, k, v))
    if lw_value is not None:
        lw = np.full((b, h, t, c), lw_value, np.float32)
    elif mild:
        lw = -np.exp(rng.standard_normal((b, h, t, c)) * 0.5)
    else:
        w = rng.standard_normal((b, h, t, c)) * 1.5 - 1.0
        lw = -np.exp(np.clip(w, -8.0, 6.0))
    u = (rng.standard_normal((h, c)) * 0.3).astype(np.float32)
    s0 = (rng.standard_normal((b, h, c, c)) * 0.3).astype(np.float32)
    return r, k, v, lw.astype(np.float32), u, s0


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / np.abs(ref).max()


def _row_rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max(-1)
    return (np.abs(out - ref).max(-1) / np.where(scale > 0, scale, 1)).max()


def _tc(r, k, v, lw, u, s0, *, chunk, dtype=None):
    t = [torch.from_numpy(x) for x in (r, k, v, lw, u, s0)]
    if dtype is not None:
        t[:3] = [x.to(dtype) for x in t[:3]]
    o, s = wkv.rwkv6_chunked_tc(*t[:5], chunk=chunk, initial_state=t[5],
                                rounding=dtype)
    return o.float().numpy(), s.numpy()


@pytest.mark.parametrize("t,chunk", [(100, 64), (100, 32), (64, 64),
                                     (5, 32), (150, 64)])
def test_two_level_arithmetic_in_fp32_matches_jax(t, chunk):
    """With fp32 operands the sub-chunk factorisation is the function,
    with an initial state and a ragged last chunk: within 1e-4 of max
    |ref| of the oracle and of the reference's chunked form, output and
    state, the measure ``chip_smoke.py`` holds the kernel to; and, on the
    decays tests/test_torch_rwkv6.py draws, elementwise within 1e-4 of
    the oracle.  (The reference's chunked form itself misses the oracle
    elementwise at 1e-4 on some of these inputs, outputs reach 80; on the
    model's decays, lw to -e^6, la reaches -25,800 in a chunk and its fp32
    rounding moves exp(la_prev - la) by about 1e-3 relative.)"""
    for mild in (True, False):
        r, k, v, lw, u, s0 = _inputs(t=t, seed=t + chunk, mild=mild)
        o, s = _tc(r, k, v, lw, u, s0, chunk=chunk)
        args = [jnp.asarray(x) for x in (r, k, v, lw, u)]
        ref, ref_s = j_ref(*args, initial_state=jnp.asarray(s0))
        j_o, j_s = rwkv6_chunked_jnp(*args, chunk=chunk,
                                     initial_state=jnp.asarray(s0))
        for out, want in ((o, ref), (s, ref_s), (o, j_o), (s, j_s)):
            assert _rel(out, want) <= 1e-4
        if mild:
            for out, want in ((o, ref), (s, ref_s)):
                np.testing.assert_allclose(out, np.asarray(want), rtol=1e-4,
                                           atol=1e-4)


@pytest.mark.parametrize("dtype", [bf16, fp16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("t,chunk", [(221, 64), (100, 32), (5, 32)])
def test_two_level_arithmetic_rounded_matches_jax(dtype, t, chunk):
    """With the tile's roundings (operands to 16 bits, the inter-chunk
    product in bf16 hi + lo, the state update as hi + lo against V) the
    output lies within 3e-2 of the oracle over the whole tensor and row
    by row, and the state within 1e-4, as ``chip_smoke.py`` holds the
    tile on the card."""
    r, k, v, lw, u, s0 = _inputs(t=t, seed=3 * t + chunk, dtype=dtype)
    o, s = _tc(r, k, v, lw, u, s0, chunk=chunk, dtype=dtype)
    args = [jnp.asarray(x) for x in (r, k, v, lw, u)]
    ref, ref_s = j_ref(*args, initial_state=jnp.asarray(s0))
    j_o, j_s = rwkv6_chunked_jnp(*args, chunk=chunk,
                                 initial_state=jnp.asarray(s0))
    for want, want_s in ((ref, ref_s), (j_o, j_s)):
        assert _rel(o, want) <= 3e-2
        assert _row_rel(o, want) <= 3e-2
        assert _rel(s, want_s) <= 1e-4


@pytest.mark.parametrize("dtype", [bf16, fp16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("lw_value", [-float(np.exp(6.0)),
                                      -float(np.exp(-8.0))],
                         ids=["lw=-e^6", "lw=-e^-8"])
def test_two_level_arithmetic_at_the_decay_limits(dtype, lw_value):
    """At the model's clip limits every value is finite: at lw = -e^6 la
    reaches -25,800 over a 64-token chunk, where a split at the chunk's
    start gives inf * 0; the sub-chunk split's factors are both <= 1.
    The output stays within 3e-2 of the oracle row by row: there each row
    is (r_t . k_{t-1}) v_{t-1} plus the bonus, a scalar that a single
    rounding of the inter-chunk operands would lose to cancellation."""
    r, k, v, lw, u, s0 = _inputs(t=130, seed=9, dtype=dtype,
                                 lw_value=lw_value)
    o, s = _tc(r, k, v, lw, u, s0, chunk=64, dtype=dtype)
    assert np.isfinite(o).all() and np.isfinite(s).all()
    ref, ref_s = j_ref(*(jnp.asarray(x) for x in (r, k, v, lw, u)),
                       initial_state=jnp.asarray(s0))
    assert _row_rel(o, ref) <= 3e-2
    assert _rel(s, ref_s) <= 1e-4

