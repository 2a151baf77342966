"""The port's RecurrentGemma (Griffin) slice against the reference's.

The RG-LRU scan's plain version (K5's) against the reference oracle
``rglru_ref`` at 1e-5 (the tolerance of ``test_recurrence_kernels.py``),
with and without an initial state; the decode step against one step of
the oracle.  The reference's Pallas RG-LRU does not run on this JAX
(``pl.store`` is gone), so the model is held against the reference's
``xla`` route: reduced RecurrentGemma in fp32 through forward, prefill
and decode within 1e-4 under both port routes, with a prompt longer than
the window of 16 and decode steps past the ring's wrap; identical greedy
serving tokens; bf16 within 2e-2 of max |logit|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.kernels.rglru.ref import rglru_decode_step as j_step  # noqa: E402
from repro.kernels.rglru.ref import rglru_ref as j_rglru_ref  # noqa: E402
from repro.models.base import family_module as j_family  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch import backend                          # noqa: E402
from repro_torch.configs.registry import get_config      # noqa: E402
from repro_torch.kernels.rglru import ops as rg_ops      # noqa: E402
from repro_torch.kernels.rglru import rglru as rg_kernel  # noqa: E402
from repro_torch.kernels.rglru.ref import rglru_decode_step  # noqa: E402
from repro_torch.launch import serve                     # noqa: E402
from repro_torch.models import recurrentgemma as rg      # noqa: E402
from repro_torch.models.base import family_module        # noqa: E402
from repro_torch.models.convert import params_from_jax   # noqa: E402
from repro_torch.serving.engine import ServingEngine     # noqa: E402

B = 2
ARCH = "recurrentgemma-2b"


def _rng(seed):
    return np.random.default_rng(seed)


def _lru_inputs(b, t, c, seed):
    rng = _rng(seed)
    log_a = -np.logaddexp(rng.standard_normal((b, t, c)), 0.0)
    x = rng.standard_normal((b, t, c))
    h0 = rng.standard_normal((b, c))
    return (log_a.astype(np.float32), x.astype(np.float32),
            h0.astype(np.float32))


def _close(out, ref, tol=1e-4):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# The RG-LRU scan (K5's plain version) and the decode step.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("t,c", [(64, 128), (100, 192), (32, 64), (1, 16)])
def test_rglru_scan_plain_matches_oracle(t, c, with_h0):
    log_a, x, h0 = _lru_inputs(B, t, c, t * c)
    init = h0 if with_h0 else None
    ref, ref_last = j_rglru_ref(jnp.asarray(log_a), jnp.asarray(x),
                                None if init is None else jnp.asarray(init))
    h, h_last = rg_ops.rglru_scan(
        torch.from_numpy(log_a), torch.from_numpy(x),
        None if init is None else torch.from_numpy(init))
    assert h.dtype == h_last.dtype == torch.float32
    assert tuple(h.shape) == (B, t, c) and tuple(h_last.shape) == (B, c)
    _close(h, ref, 1e-5)
    _close(h_last, ref_last, 1e-5)


def test_rglru_pure_integrator_limit():
    """log_a -> 0: a -> 1 and beta -> 0, so h stays at h0 (beta computed
    as sqrt(-expm1(2 la)) keeps its digits there)."""
    _, x, h0 = _lru_inputs(B, 40, 32, 1)
    log_a = np.full_like(x, -1e-9)
    h, h_last = rg_ops.rglru_scan(torch.from_numpy(log_a),
                                  torch.from_numpy(x), torch.from_numpy(h0))
    ref, _ = j_rglru_ref(jnp.asarray(log_a), jnp.asarray(x),
                         jnp.asarray(h0))
    _close(h, ref, 1e-5)
    np.testing.assert_allclose(h_last.numpy(), h0, rtol=1e-3, atol=1e-3)


def test_rglru_decode_step_matches_one_oracle_step():
    log_a, x, h0 = _lru_inputs(3, 1, 48, 7)
    out, new = rglru_decode_step(torch.from_numpy(h0),
                                 torch.from_numpy(log_a[:, 0]),
                                 torch.from_numpy(x[:, 0]))
    j_out, j_new = j_step(jnp.asarray(h0), jnp.asarray(log_a[:, 0]),
                          jnp.asarray(x[:, 0]))
    ref, ref_last = j_rglru_ref(jnp.asarray(log_a), jnp.asarray(x),
                                jnp.asarray(h0))
    _close(out, j_out, 1e-6)
    _close(new, j_new, 1e-6)
    _close(out, ref[:, 0], 1e-6)
    _close(new, ref_last, 1e-6)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that says it lies on a CUDA card."""

    @property
    def is_cuda(self):
        return True


def test_rglru_scan_raises_instead_of_falling_back(monkeypatch):
    def fail(*args, **kwargs):
        raise RuntimeError("rglru_scan kernel launch failed: CUDA error 700")
    monkeypatch.setattr(rg_ops, "rglru_scan_cuda", fail)
    x = torch.Tensor._make_subclass(_FakeCuda, torch.ones(2, 3, 4))
    before = rg_ops.rglru_scan.launches
    with pytest.raises(RuntimeError, match="error 700"):
        rg_ops.rglru_scan(-torch.ones(2, 3, 4), x)
    assert rg_ops.rglru_scan.launches == before
    # A launch that returns a CUDA error raises too.
    monkeypatch.setattr(rg_kernel, "_launcher", lambda: lambda *a: 700)

    class _Stream:
        cuda_stream = None
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        rg_kernel.rglru_scan_cuda(-torch.ones(2, 3, 4), torch.ones(2, 3, 4))
    with pytest.raises(NotImplementedError):
        rg_kernel.rglru_scan_cuda(-torch.ones(2, 3, 4),
                                  torch.ones(2, 3, 4, dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# Reduced RecurrentGemma end to end.
# ---------------------------------------------------------------------------

def _cfgs(jax_dtype=jnp.float32, torch_dtype=torch.float32):
    jcfg = j_get_config(ARCH, reduced=True).with_(
        remat="none", dtype=jax_dtype, kv_cache_dtype=jax_dtype,
        backend="xla")
    tcfg = get_config(ARCH, reduced=True).with_(
        dtype=torch_dtype, kv_cache_dtype=torch_dtype)
    return jcfg, tcfg


def _perturbed(params, rng):
    """Norm weights and gate biases made non-trivial (init leaves them 0)."""
    def leaf(path, x):
        name = str(getattr(path[-1], "key", ""))
        if name.startswith(("ln", "b_", "conv_b")):
            return x + 0.1 * rng.standard_normal(x.shape).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(leaf, params)


@pytest.fixture(scope="module")
def fp32_model():
    jcfg, tcfg = _cfgs()
    jparams = _perturbed(j_family(jcfg).init(jcfg, jax.random.PRNGKey(0)),
                         _rng(9))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


def test_params_carry_across_with_the_same_structure(fp32_model):
    """``triples`` (a tuple of stacked dicts) and ``tail`` (a tuple of
    dicts) leaf by leaf; the port's own init draws the same shapes and
    dtypes."""
    jcfg, tcfg, jparams, tparams = fp32_model
    ours = rg.init(tcfg, torch.Generator().manual_seed(0))
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    # embedding, ln_final; per rec block 10 + 2 norms + 2 mlp, per attn
    # block 4 + 2 + 2; two stacked rec, one stacked attn, two tail rec
    assert len(flat) == 2 + 2 * 14 + 8 + 2 * 14
    for path, leaf in flat:
        a, b = tparams, ours
        for key in path:
            k = getattr(key, "key", getattr(key, "idx", None))
            a, b = a[k], b[k]
        assert tuple(a.shape) == leaf.shape == tuple(b.shape)
        assert a.dtype == b.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(leaf))
    assert isinstance(tparams["triples"], tuple)
    assert isinstance(tparams["tail"], tuple) and len(tparams["tail"]) == 2


def _run_both(jcfg, tcfg, jparams, tparams, toks, n_decode):
    """Forward, prefill and decode of both packages; asserts each step and
    the final states."""
    jmod = j_family(jcfg)
    s = toks.shape[1]
    _close(rg.forward(tcfg, tparams, {"tokens": torch.from_numpy(toks)}),
           jmod.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)}))
    jcache = jmod.init_cache(jcfg, B, s + n_decode)
    tcache = rg.init_cache(tcfg, B, s + n_decode)
    jl, jcache = jmod.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                              jcache)
    tl, tcache = rg.prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks)},
                            tcache)
    _close(tl, jl)
    for i in range(n_decode):
        tok = np.array(jnp.argmax(jl, axis=-1))[:, None]
        jl, jcache = jmod.decode_step(jcfg, jparams, jnp.asarray(tok),
                                      jcache, s + i)
        tl, tcache = rg.decode_step(tcfg, tparams, torch.from_numpy(tok),
                                    tcache, s + i)
        _close(tl, jl)
    jflat = jax.tree_util.tree_flatten_with_path(jcache)[0]
    for path, leaf in jflat:
        t = tcache
        for key in path:
            t = t[getattr(key, "key", getattr(key, "idx", None))]
        _close(t, leaf)


@pytest.mark.parametrize("s,n_decode", [(12, 3), (21, 5), (14, 4)],
                         ids=["short", "past-window", "decode-wraps"])
@pytest.mark.parametrize("port_route", ["kernel", "torch"])
def test_forward_prefill_decode_match_jax(fp32_model, port_route, s,
                                          n_decode):
    """``past-window``: a 21-token prompt fills the ring of 16 through the
    clamped write; ``decode-wraps``: decode from 14 to 18 wraps the ring."""
    jcfg, tcfg, jparams, tparams = fp32_model
    toks = _rng(s).integers(0, jcfg.vocab_size, (B, s))
    prev = backend.set_default_matmul_backend(port_route)
    try:
        _run_both(jcfg, tcfg.with_(backend=port_route), jparams, tparams,
                  toks, n_decode)
    finally:
        backend.set_default_matmul_backend(prev)


def test_ring_write_clamps_as_the_reference():
    k = torch.zeros(1, 1, 4, 1)
    v = torch.zeros(1, 1, 4, 1)
    new = torch.arange(1.0, 5.0).reshape(1, 1, 4, 1)
    rg._ring_write(k, v, new, new, 3)          # start clamped to 0
    assert k.flatten().tolist() == [1.0, 2.0, 3.0, 4.0]
    rg._ring_write(k, v, new[:, :, :1] * 10, new[:, :, :1], 2)
    assert k.flatten().tolist() == [1.0, 2.0, 10.0, 4.0]


def test_serving_engine_greedy_tokens_identical(fp32_model):
    jcfg, tcfg, jparams, tparams = fp32_model
    lengths = [5, 9, 3, 18]
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
    out = rg.forward(tcfg, tparams, {"tokens": torch.from_numpy(toks)})
    assert out.dtype == torch.float32
    err = np.abs(out.numpy() - ref).max() / np.abs(ref).max()
    assert err <= 2e-2, err


def test_family_is_registered():
    _, tcfg = _cfgs()
    assert family_module(tcfg) is rg


def test_launcher_serves_recurrentgemma_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                "--requests", "3", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "served 3 requests, 9 tokens on cpu" in out
