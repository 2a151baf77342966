"""The port's paged attention (``repro_torch.kernels.attention.paged``)
against the reference's and against its own contiguous calls.

The gather is a row permutation into contiguous memory, so paged
attention must equal the contiguous call bit for bit in the port, int8
and fp32 alike; the block table must be the reference's for the same
seed (both shuffle with ``random.Random(seed)``); and the port's paged
outputs must lie within tests/test_torch_attention.py's tolerances of
the reference's (1e-3 fp32 flash, 1e-4 decode, relative to max |ref|).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.attention import paged as jpaged            # noqa: E402
from repro_torch.kernels.attention import ops as tops          # noqa: E402
from repro_torch.kernels.attention.paged import (              # noqa: E402
    gather_paged, paged_decode_attention, paged_flash_attention, to_paged)

TOL_FLASH, TOL_DECODE = 1e-3, 1e-4


def _caches(seed=0, b=2, hkv=2, s=40, d=16, dtype="int8"):
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        k, v = (rng.integers(-127, 128, (b, hkv, s, d)).astype(np.int8)
                for _ in range(2))
    else:
        k, v = (rng.standard_normal((b, hkv, s, d)).astype(np.float32)
                for _ in range(2))
    return k, v


def _q(seed, shape, dtype="int8"):
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        return rng.integers(-127, 128, shape).astype(np.int8)
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _err(out, ref):
    o = np.asarray(out, np.float64)
    r = np.asarray(ref, np.float64)
    return np.abs(o - r).max() / (np.abs(r).max() + 1e-9)


# ----- page layout ----------------------------------------------------------

@pytest.mark.parametrize("s", (40, 37), ids=("whole", "ragged-tail"))
def test_round_trip(s):
    k, v = _caches(s=s)
    kp, vp, table = to_paged(_t(k), _t(v), 8, seed=3)
    assert kp.shape == (2 * -(-s // 8), 2, 8, 16)
    assert torch.equal(gather_paged(kp, table, s), _t(k))
    assert torch.equal(gather_paged(vp, table, s), _t(v))


@pytest.mark.parametrize("seed,block", [(0, 8), (2, 8), (5, 4), (7, 16)])
def test_table_and_pages_equal_the_reference(seed, block):
    k, v = _caches(s=37)
    kp, vp, table = to_paged(_t(k), _t(v), block, seed=seed)
    jkp, jvp, jtable = jpaged.to_paged(jnp.asarray(k), jnp.asarray(v), block,
                                       seed=seed)
    assert table.dtype == torch.int32
    assert np.array_equal(table.numpy(), np.asarray(jtable))
    assert np.array_equal(kp.numpy(), np.asarray(jkp))
    assert np.array_equal(vp.numpy(), np.asarray(jvp))
    flat = table.flatten().tolist()
    assert sorted(flat) == list(range(len(flat)))


def test_to_paged_validates():
    k, v = (_t(x) for x in _caches())
    with pytest.raises(ValueError, match="block_tokens"):
        to_paged(k, v, 0)
    with pytest.raises(ValueError, match="mismatch"):
        to_paged(k, v[:, :, :-1], 8)


# ----- paged equals contiguous, bit for bit, in the port --------------------

@pytest.mark.parametrize("dtype", ("int8", "fp32"))
@pytest.mark.parametrize("block", (4, 8, 16))
def test_paged_decode_equals_contiguous(dtype, block):
    k, v = (_t(x) for x in _caches(s=40, dtype=dtype))
    q = _t(_q(9, (2, 4, 1, 16), dtype))
    cache_len = torch.tensor([33, 40])
    ref = tops.decode_attention(q, k, v, cache_len, window=16, softcap=50.0)
    kp, vp, table = to_paged(k, v, block, seed=7)
    got = paged_decode_attention(q, kp, vp, table, cache_len, seq_len=40,
                                 window=16, softcap=50.0)
    assert got.dtype == q.dtype
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", ("int8", "fp32"))
@pytest.mark.parametrize("flags", [dict(), dict(causal=False),
                                   dict(window=8, softcap=20.0)],
                         ids=("causal", "noncausal", "window-softcap"))
def test_paged_flash_equals_contiguous(dtype, flags):
    k, v = (_t(x) for x in _caches(seed=2, s=37, dtype=dtype))
    q = _t(_q(3, (2, 8, 37, 16), dtype))                # GQA 8 / 2
    ref = tops.flash_attention(q, k, v, **flags)
    kp, vp, table = to_paged(k, v, 8, seed=5)
    got = paged_flash_attention(q, kp, vp, table, seq_len=37, **flags)
    assert got.dtype == q.dtype
    assert torch.equal(got, ref)


def test_paged_independent_of_page_placement():
    k, v = (_t(x) for x in _caches(s=32, dtype="fp32"))
    q = _t(_q(1, (2, 4, 1, 16), "fp32"))
    outs = []
    for seed in (0, 1, 2):
        kp, vp, table = to_paged(k, v, 8, seed=seed)
        outs.append(paged_decode_attention(q, kp, vp, table,
                                           torch.tensor([32, 30]),
                                           seq_len=32))
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2])


# ----- the port against the reference ---------------------------------------

def test_paged_decode_vs_reference():
    k, v = _caches(seed=4, s=48, dtype="fp32")
    q = _q(5, (2, 4, 1, 16), "fp32")
    cache_len = np.array([48, 21])
    kw = dict(seq_len=48, window=16, softcap=50.0)
    jkp, jvp, jtable = jpaged.to_paged(jnp.asarray(k), jnp.asarray(v), 8,
                                       seed=2)
    ref = jpaged.paged_decode_attention(jnp.asarray(q), jkp, jvp, jtable,
                                        jnp.asarray(cache_len), **kw)
    kp, vp, table = to_paged(_t(k), _t(v), 8, seed=2)
    got = paged_decode_attention(_t(q), kp, vp, table, _t(cache_len), **kw)
    assert _err(got.numpy(), ref) <= TOL_DECODE


@pytest.mark.parametrize("flags", [dict(), dict(causal=False)],
                         ids=("causal", "noncausal"))
def test_paged_flash_vs_reference(flags):
    k, v = _caches(seed=6, s=32, dtype="fp32")
    q = _q(8, (2, 4, 32, 16), "fp32")
    jkp, jvp, jtable = jpaged.to_paged(jnp.asarray(k), jnp.asarray(v), 8,
                                       seed=4)
    ref = jpaged.paged_flash_attention(jnp.asarray(q), jkp, jvp, jtable,
                                       seq_len=32, block_q=16, block_kv=16,
                                       **flags)
    kp, vp, table = to_paged(_t(k), _t(v), 8, seed=4)
    got = paged_flash_attention(_t(q), kp, vp, table, seq_len=32, **flags)
    assert _err(got.numpy(), ref) <= TOL_FLASH
