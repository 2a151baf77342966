"""The port's flash attention (its plain version, on the CPU) and decode
attention against the reference: JAX ``flash_attention`` in interpret
mode and ``attention_ref``.  Tolerances as in
tests/test_attention_kernel.py: 1e-3 fp32 flash, 4e-2 bf16, 1e-4 decode,
relative to max |ref|."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.attention import ops as jops          # noqa: E402
from repro.kernels.attention.ref import attention_ref as j_ref  # noqa: E402
from repro.models import common as jcm                   # noqa: E402
from repro_torch.configs.registry import get_config      # noqa: E402
from repro_torch.kernels.attention import ops as tops    # noqa: E402
from repro_torch.kernels.attention.ref import attention_ref  # noqa: E402
from repro_torch.models import common as tcm             # noqa: E402


def _f32(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x).astype(np.float32))


def _err(out, ref):
    o, r = _f32(out).astype(np.float64), _f32(ref).astype(np.float64)
    return np.abs(o - r).max() / (np.abs(r).max() + 1e-9)


def _qkv(seed, b, h, hkv, sq, sk, d, bf16=False):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                             torch.float32)
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


# (b, h, hkv, sq, sk, d, flags)
CASES = [
    (2, 4, 2, 70, 70, 32, dict(causal=True)),                 # GQA, ragged
    (1, 4, 1, 33, 100, 16, dict(causal=False)),               # MQA, Sq < Sk
    (1, 2, 1, 64, 64, 32, dict(causal=True, window=16, softcap=5.0)),
    (1, 4, 2, 24, 96, 32, dict(causal=True, q_start=72)),     # chunk tail
    (1, 2, 1, 30, 120, 32, dict(causal=True, q_start=50, window=20,
                               softcap=20.0)),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"b{c[0]}h{c[1]}kv"
                         f"{c[2]}q{c[3]}k{c[4]}d{c[5]}-"
                         + "-".join(f"{k}{v}" for k, v in c[6].items()))
def test_flash_vs_jax_pallas_and_ref(case):
    b, h, hkv, sq, sk, d, flags = case
    (jq, jk, jv), (tq, tk, tv) = _qkv(0, b, h, hkv, sq, sk, d)
    out = tops.flash_attention(tq, tk, tv, **flags)
    pallas = jops.flash_attention(jq, jk, jv, block_q=32, block_kv=32,
                                  interpret=True, **flags)
    ref = j_ref(jq, jk, jv, **flags)
    assert out.shape == (b, h, sq, d) and out.dtype == torch.float32
    assert _err(out, pallas) <= 1e-3
    assert _err(out, ref) <= 1e-3
    assert _err(attention_ref(tq, tk, tv, **flags), ref) <= 1e-5


def test_flash_bf16():
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 1, 4, 2, 64, 64, 32, bf16=True)
    out = tops.flash_attention(tq, tk, tv, causal=True)
    ref = jops.flash_attention(jq, jk, jv, causal=True, block_q=32,
                               block_kv=32, interpret=True)
    assert out.dtype == torch.bfloat16
    assert _err(out, ref) <= 4e-2


def test_fully_masked_rows_are_exactly_zero():
    """Queries at 100.. with a window of 4 see none of the 40 keys."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, 1, 2, 1, 8, 40, 32)
    kw = dict(causal=True, window=4, q_start=100)
    out = tops.flash_attention(tq, tk, tv, **kw)
    pallas = jops.flash_attention(jq, jk, jv, interpret=True, **kw)
    assert not torch.isnan(out).any()
    assert torch.equal(out, torch.zeros_like(out))
    np.testing.assert_array_equal(_f32(out), _f32(pallas))


@pytest.mark.parametrize("flags", [dict(causal=True),
                                   dict(causal=True, window=8, softcap=4.0),
                                   dict(causal=False, q_start=3)],
                         ids=["causal", "window-softcap", "q_start"])
def test_chunked_torch_route_vs_jax_xla_chunked(flags):
    (jq, jk, jv), (tq, tk, tv) = _qkv(3, 2, 4, 2, 37, 37, 16)
    out = tcm.attention_chunked(tq, tk, tv, sm_scale=0.25, chunk=16,
                                **flags)
    ref = jcm.attention_xla_chunked(jq, jk, jv, sm_scale=0.25, chunk=16,
                                    **flags)
    assert _err(out, ref) <= 1e-5


@pytest.mark.parametrize("flags", [dict(causal=True),
                                   dict(causal=True, window=8, softcap=4.0),
                                   dict(causal=False, q_start=3)],
                         ids=["causal", "window-softcap", "q_start"])
def test_chunked_torch_route_pv_bf16_vs_jax_xla_chunked(flags):
    """``pv_bf16`` rounds P and V to bf16 as the reference's lever does:
    the two agree as closely as without it, while each lies a bf16
    rounding from the fp32 product."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(3, 2, 4, 2, 37, 37, 16)
    kw = dict(sm_scale=0.25, chunk=16, **flags)
    out = tcm.attention_chunked(tq, tk, tv, pv_bf16=True, **kw)
    ref = jcm.attention_xla_chunked(jq, jk, jv, pv_bf16=True, **kw)
    assert _err(out, ref) <= 1e-5
    assert _err(out, tcm.attention_chunked(tq, tk, tv, **kw)) > 1e-4


@pytest.mark.parametrize("backend", ["kernel", "torch", "dense"])
def test_attention_dispatch_routes_agree(backend):
    cfg = get_config("yi-6b", reduced=True).with_(backend=backend)
    (jq, jk, jv), (tq, tk, tv) = _qkv(4, 1, 4, 2, 20, 20, 16)
    out = tcm.attention(cfg, tq, tk, tv, causal=True)
    ref = j_ref(jq, jk, jv, causal=True, sm_scale=cfg.sm_scale)
    assert _err(out, ref) <= 1e-5


@pytest.mark.parametrize("cache_len,window", [(37, 0), ([5, 64], 0),
                                              (50, 16)],
                         ids=["scalar", "per-batch", "window"])
def test_decode_attention_vs_jax(cache_len, window):
    b = 2
    (jq, jk, jv), (tq, tk, tv) = _qkv(5, b, 4, 2, 1, 64, 32)
    jl = jnp.asarray(cache_len)
    out = tops.decode_attention(tq, tk, tv, cache_len, window=window,
                                softcap=2.0)
    ref = jops.decode_attention(jq, jk, jv, jl, window=window, softcap=2.0)
    assert out.shape == (b, 4, 1, 32)
    assert _err(out, ref) <= 1e-4
