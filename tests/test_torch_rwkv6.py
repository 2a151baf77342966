"""The port's RWKV-6 slice against the reference's.

The chunked WKV's plain version (K6's) against the reference's Pallas
kernel (interpret mode), its ``rwkv6_chunked_jnp`` and the per-token
oracle ``rwkv6_ref`` at 1e-4 (the tolerance of
``test_recurrence_kernels.py``), with chunks 32 and 64, a ragged T, an
initial state and state continuation; ``layernorm`` and
``groupnorm_heads``; reduced RWKV-6 in fp32 through forward, prefill and
decode within 1e-4 under the reference's ``xla`` and ``pallas`` routes
and the port's ``kernel``, ``torch`` and ``dense`` routes; identical
greedy serving tokens; bf16 within 2e-2 of max |logit|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.models.common as j_cm                       # noqa: E402
from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.kernels.rwkv6.ops import rwkv6_scan as j_scan  # noqa: E402
from repro.kernels.rwkv6.ref import rwkv6_ref as j_ref   # noqa: E402
from repro.models.base import family_module as j_family  # noqa: E402
from repro.models.rwkv6 import rwkv6_chunked_jnp         # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch import backend                          # noqa: E402
from repro_torch.configs.registry import get_config      # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wkv_ops     # noqa: E402
from repro_torch.kernels.rwkv6 import rwkv6 as wkv_kernel  # noqa: E402
from repro_torch.kernels.rwkv6.ref import rwkv6_ref      # noqa: E402
from repro_torch.launch import serve                     # noqa: E402
from repro_torch.models import common as cm              # noqa: E402
from repro_torch.models import rwkv6 as rw               # noqa: E402
from repro_torch.models.base import family_module        # noqa: E402
from repro_torch.models.convert import params_from_jax   # noqa: E402
from repro_torch.serving.engine import ServingEngine     # noqa: E402

B = 2
ARCH = "rwkv6-7b"


def _rng(seed):
    return np.random.default_rng(seed)


def _wkv_inputs(b=2, h=3, t=96, c=64, seed=0):
    rng = _rng(seed)
    r, k, v = (rng.standard_normal((b, h, t, c)).astype(np.float32)
               for _ in range(3))
    lw = -np.exp(rng.standard_normal((b, h, t, c)) * 0.5).astype(np.float32)
    u = (rng.standard_normal((h, c)) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((b, h, c, c)) * 0.3).astype(np.float32)
    return r, k, v, lw, u, s0


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _close(out, ref, tol=1e-4):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# The chunked WKV (K6's plain version) and the oracle.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("t", [32, 70, 96])
def test_rwkv6_scan_plain_matches_pallas_and_oracle(t, chunk):
    r, k, v, lw, u, _ = _wkv_inputs(t=t)
    o, state = wkv_ops.rwkv6_scan(*_t(r, k, v, lw, u), chunk=chunk)
    ref, ref_state = j_ref(*_j(r, k, v, lw, u))
    assert o.dtype == torch.float32 and tuple(o.shape) == r.shape
    _close(o, j_scan(*_j(r, k, v, lw, u), chunk=chunk))
    _close(o, ref)
    _close(state, ref_state)


@pytest.mark.parametrize("chunk", [32, 64])
def test_rwkv6_chunked_with_initial_state_matches_jax(chunk):
    r, k, v, lw, u, s0 = _wkv_inputs(t=80, c=32, seed=1)
    o, state = wkv_kernel.rwkv6_chunked(*_t(r, k, v, lw, u), chunk=chunk,
                                        initial_state=torch.from_numpy(s0))
    j_o, j_state = rwkv6_chunked_jnp(*_j(r, k, v, lw, u), chunk=chunk,
                                     initial_state=jnp.asarray(s0))
    ref, ref_state = j_ref(*_j(r, k, v, lw, u), initial_state=jnp.asarray(s0))
    for out, want in ((o, j_o), (state, j_state), (o, ref),
                      (state, ref_state)):
        _close(out, want)


def test_rwkv6_state_continuation():
    """scan(T) == scan(T1) then scan(T - T1) from the carried state."""
    r, k, v, lw, u, _ = _wkv_inputs(t=100, seed=2)
    full, s_full = wkv_ops.rwkv6_scan(*_t(r, k, v, lw, u), chunk=64)
    cut = 37
    h1, s1 = wkv_ops.rwkv6_scan(*_t(*(x[:, :, :cut] for x in (r, k, v, lw)),
                                    u), chunk=64)
    h2, s2 = wkv_ops.rwkv6_scan(*_t(*(x[:, :, cut:] for x in (r, k, v, lw)),
                                    u), chunk=32, initial_state=s1)
    _close(h1, full[:, :, :cut].numpy())
    _close(h2, full[:, :, cut:].numpy())
    _close(s2, s_full.numpy())


def test_rwkv6_ref_matches_jax_oracle():
    r, k, v, lw, u, s0 = _wkv_inputs(t=9, c=16, seed=3)
    o, state = rwkv6_ref(*_t(r, k, v, lw, u),
                         initial_state=torch.from_numpy(s0))
    j_o, j_state = j_ref(*_j(r, k, v, lw, u), initial_state=jnp.asarray(s0))
    _close(o, j_o, 1e-5)
    _close(state, j_state, 1e-5)


def test_rwkv6_bf16_inputs_give_bf16_output():
    r, k, v, lw, u, _ = _wkv_inputs(t=40, c=32, seed=4)
    rb, kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (r, k, v))
    o, state = wkv_ops.rwkv6_scan(rb, kb, vb, *_t(lw, u), chunk=32)
    ref, _ = j_ref(*(jnp.asarray(x, jnp.bfloat16) for x in (r, k, v)),
                   *_j(lw, u))
    assert o.dtype == torch.bfloat16 and state.dtype == torch.float32
    ref = np.asarray(ref, np.float32)
    err = np.abs(o.float().numpy() - ref).max() / np.abs(ref).max()
    assert err <= 2e-2, err


class _FakeCuda(torch.Tensor):
    """A CPU tensor that says it lies on a CUDA card."""

    @property
    def is_cuda(self):
        return True


def test_rwkv6_scan_raises_instead_of_falling_back(monkeypatch):
    def fail(*args, **kwargs):
        raise RuntimeError("rwkv6_wkv kernel launch failed: CUDA error 700")
    monkeypatch.setattr(wkv_ops, "rwkv6_wkv_cuda", fail)
    r, k, v, lw, u, _ = _t(*_wkv_inputs(t=8, c=8))
    fake = torch.Tensor._make_subclass(_FakeCuda, r)
    before = wkv_ops.rwkv6_scan.launches
    with pytest.raises(RuntimeError, match="error 700"):
        wkv_ops.rwkv6_scan(fake, k, v, lw, u)
    assert wkv_ops.rwkv6_scan.launches == before
    # A launch that returns a CUDA error raises too.
    monkeypatch.setattr(wkv_kernel, "_launcher", lambda: lambda *a: 700)

    class _Stream:
        cuda_stream = None
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        wkv_kernel.rwkv6_wkv_cuda(r, k, v, lw, u, chunk=32)
    with pytest.raises(NotImplementedError):
        wkv_kernel.rwkv6_wkv_cuda(r, k, v, lw, u, chunk=16)


# ---------------------------------------------------------------------------
# Norms.
# ---------------------------------------------------------------------------

def test_layernorm_and_groupnorm_match_jax():
    rng = _rng(5)
    x = (rng.standard_normal((2, 7, 96)) * 3 + 1).astype(np.float32)
    w, b = (rng.standard_normal(96).astype(np.float32) for _ in range(2))
    _close(cm.layernorm(*_t(x, w, b)), j_cm.layernorm(*_j(x, w, b)), 1e-5)
    _close(cm.groupnorm_heads(*_t(x, w, b), 4),
           j_cm.groupnorm_heads(*_j(x, w, b), 4), 1e-5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert cm.layernorm(xb, *_t(w, b)).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# Reduced RWKV-6 end to end.
# ---------------------------------------------------------------------------

def _cfgs(jax_dtype=jnp.float32, torch_dtype=torch.float32):
    jcfg = j_get_config(ARCH, reduced=True).with_(
        remat="none", dtype=jax_dtype, kv_cache_dtype=jax_dtype)
    tcfg = get_config(ARCH, reduced=True).with_(
        dtype=torch_dtype, kv_cache_dtype=torch_dtype)
    return jcfg, tcfg


def _perturbed(params, rng):
    """Norm weights and biases made non-trivial (init leaves them 0/1)."""
    def leaf(path, x):
        name = str(getattr(path[-1], "key", ""))
        if name.startswith("ln"):
            return x + 0.1 * rng.standard_normal(x.shape).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(leaf, params)


@pytest.fixture(scope="module")
def fp32_model():
    jcfg, tcfg = _cfgs()
    jparams = _perturbed(j_family(jcfg).init(jcfg, jax.random.PRNGKey(0)),
                         _rng(8))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


def test_params_carry_across_with_the_same_structure(fp32_model):
    """``layers`` is one stacked dict, leaf by leaf; the port's own init
    draws the same shapes and dtypes (``w0`` and ``u`` in fp32)."""
    jcfg, tcfg, jparams, tparams = fp32_model
    ours = rw.init(tcfg, torch.Generator().manual_seed(0))
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == 6 + 24
    for path, leaf in flat:
        a, b = tparams, ours
        for key in path:
            k = getattr(key, "key", getattr(key, "idx", None))
            a, b = a[k], b[k]
        assert tuple(a.shape) == leaf.shape == tuple(b.shape)
        assert a.dtype == b.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(leaf))
    bf = rw.init(tcfg.with_(dtype=torch.bfloat16),
                 torch.Generator().manual_seed(0))["layers"]
    assert bf["w0"].dtype == bf["u"].dtype == torch.float32
    assert bf["w_r"].dtype == torch.bfloat16


@pytest.mark.parametrize("s,n_decode", [(12, 3), (70, 2)],
                         ids=["short", "ragged-chunks"])
@pytest.mark.parametrize("port_route", ["kernel", "torch", "dense"])
@pytest.mark.parametrize("jax_route", ["xla", "pallas"])
def test_forward_prefill_decode_match_jax(fp32_model, jax_route, port_route,
                                          s, n_decode):
    """``ragged-chunks``: a 70-token prompt is two chunks of 32 and a
    ragged one in ``forward`` (kernel route), and one of 64 and a ragged
    one at prefill."""
    jcfg, tcfg, jparams, tparams = fp32_model
    jcfg = jcfg.with_(backend=jax_route)
    tcfg = tcfg.with_(backend=port_route)
    jmod = j_family(jcfg)
    toks = _rng(s).integers(0, jcfg.vocab_size, (B, s))
    prev = backend.set_default_matmul_backend(
        "torch" if port_route == "dense" else port_route)
    try:
        _close(rw.forward(tcfg, tparams, {"tokens": torch.from_numpy(toks)}),
               jmod.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)}))
        jcache = jmod.init_cache(jcfg, B, s + n_decode)
        tcache = rw.init_cache(tcfg, B, s + n_decode)
        jl, jcache = jmod.prefill(jcfg, jparams,
                                  {"tokens": jnp.asarray(toks)}, jcache)
        tl, tcache = rw.prefill(tcfg, tparams,
                                {"tokens": torch.from_numpy(toks)}, tcache)
        _close(tl, jl)
        for i in range(n_decode):
            tok = np.array(jnp.argmax(jl, axis=-1))[:, None]
            jl, jcache = jmod.decode_step(jcfg, jparams, jnp.asarray(tok),
                                          jcache, s + i)
            tl, tcache = rw.decode_step(tcfg, tparams, torch.from_numpy(tok),
                                        tcache, s + i)
            _close(tl, jl)
        for key in ("tm_shift", "cm_shift", "wkv"):
            _close(tcache[key], jcache[key])
    finally:
        backend.set_default_matmul_backend(prev)


def test_serving_engine_greedy_tokens_identical(fp32_model):
    jcfg, tcfg, jparams, tparams = fp32_model
    lengths = [5, 9, 3, 12]
    prompts = [_rng(10 + i).integers(0, jcfg.vocab_size, (n,))
               for i, n in enumerate(lengths)]
    jeng = JEngine(jcfg, jparams, max_batch=2, cache_len=32)
    teng = ServingEngine(tcfg, tparams, max_batch=2, cache_len=32)
    for p in prompts:
        jeng.submit(jnp.asarray(p, jnp.int32))
        teng.submit(torch.from_numpy(p))
    jout = jeng.run(max_new_tokens=6)
    tout = teng.run(max_new_tokens=6)
    assert len(tout) == len(jout) == len(prompts)
    for t, j in zip(tout, jout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_bf16_forward_within_2e2():
    jcfg, tcfg = _cfgs(jnp.bfloat16, torch.bfloat16)
    jparams = j_family(jcfg).init(jcfg, jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    toks = _rng(2).integers(0, jcfg.vocab_size, (B, 12))
    ref = np.asarray(j_family(jcfg).forward(
        jcfg, jparams, {"tokens": jnp.asarray(toks)}))
    out = rw.forward(tcfg, tparams, {"tokens": torch.from_numpy(toks)})
    assert out.dtype == torch.float32
    err = np.abs(out.numpy() - ref).max() / np.abs(ref).max()
    assert err <= 2e-2, err


def test_family_is_registered():
    _, tcfg = _cfgs()
    assert family_module(tcfg) is rw


def test_launcher_serves_rwkv6_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                "--requests", "3", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "served 3 requests, 9 tokens on cpu" in out
