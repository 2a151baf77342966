"""The port's MoE slice against the reference's, on the same inputs.

The grouped GEMM's plain version against the reference's Pallas kernel
(interpret mode) at the reference test's shapes and tolerances; the
dispatch of ``moe_apply_local`` (router choices and the dispatched
buffer, hence every slot) identical, its output within 1e-5 in fp32;
reduced OLMoE and Arctic through forward, prefill and decode at the
fp32 tolerance of ``test_torch_transformer.py`` (1e-4) under both
reference routes and both port routes; identical greedy serving tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.models.moe as j_moe                         # noqa: E402
from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.core.fusion import Epilogue as JEpilogue      # noqa: E402
from repro.kernels.moe.ops import grouped_matmul as j_grouped  # noqa: E402
from repro.models.base import family_module as j_family  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch import backend                          # noqa: E402
from repro_torch.configs.registry import get_config      # noqa: E402
from repro_torch.core.fusion import (ACTIVATIONS, NO_OPERANDS,  # noqa: E402
                                     Epilogue, apply_epilogue)
from repro_torch.kernels.moe import ops as gm_ops        # noqa: E402
from repro_torch.models import moe                       # noqa: E402
from repro_torch.models import transformer as tt         # noqa: E402
from repro_torch.models.convert import params_from_jax   # noqa: E402
from repro_torch.serving.engine import ServingEngine     # noqa: E402

B, S, DECODE = 2, 12, 3
ARCHS = ("olmoe-1b-7b", "arctic-480b")


def _rng(seed):
    return np.random.default_rng(seed)


def _cfgs(arch, jax_route="xla", port_route="torch"):
    jcfg = j_get_config(arch, reduced=True).with_(
        remat="none", dtype=jnp.float32, kv_cache_dtype=jnp.float32,
        backend=jax_route)
    tcfg = get_config(arch, reduced=True).with_(
        dtype=torch.float32, kv_cache_dtype=torch.float32, backend=port_route)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg, tcfg = _cfgs(request.param)
    jparams = j_family(jcfg).init(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    return request.param, jparams, tparams


# ---------------------------------------------------------------------------
# The grouped GEMM (K4's plain version) against the Pallas kernel.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e,cap,k,n", [(4, 96, 128, 256), (2, 64, 64, 128),
                                       (8, 33, 128, 128)])
def test_grouped_matmul_fp32_matches_pallas(e, cap, k, n):
    x = _rng(e * cap).standard_normal((e, cap, k)).astype(np.float32)
    w = _rng(k * n).standard_normal((e, k, n)).astype(np.float32)
    ref = j_grouped(jnp.asarray(x), jnp.asarray(w), block_shape=(64, 128, 64))
    out = gm_ops.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert out.dtype == torch.float32 and tuple(out.shape) == (e, cap, n)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=1e-4)


def test_grouped_matmul_glu_bf16_matches_pallas():
    e, cap, k, n = 4, 64, 128, 128
    x = jnp.asarray(_rng(1).standard_normal((e, cap, k)), jnp.bfloat16)
    w = jnp.asarray(_rng(2).standard_normal((e, k, 2 * n)), jnp.bfloat16)
    ref = j_grouped(x, w, epilogue=JEpilogue(activation="silu", glu=True,
                                             out_dtype=jnp.bfloat16),
                    block_shape=(64, 128, 64))
    tx, tw = (params_from_jax(np.asarray(a)) for a in (x, w))
    out = gm_ops.grouped_matmul(tx, tw.reshape(e, k, 2, n), epilogue=Epilogue(
        activation="silu", glu=True, out_dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (e, cap, n)
    o, r = out.float().numpy(), np.asarray(ref, np.float32)
    assert np.abs(o - r).max() / (np.abs(r).max() + 1e-9) < 2e-2


def test_grouped_matmul_int8_exact():
    x = _rng(3).integers(-127, 128, (3, 20, 96)).astype(np.int8)
    w = _rng(4).integers(-127, 128, (3, 96, 40)).astype(np.int8)
    ref = j_grouped(jnp.asarray(x), jnp.asarray(w), block_shape=(64, 128, 64))
    out = gm_ops.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_grouped_matmul_refuses_epilogue_operands():
    x, w = torch.zeros(2, 3, 4), torch.zeros(2, 4, 6)
    with pytest.raises(ValueError, match="no operands"):
        gm_ops.grouped_matmul(x, w, epilogue=Epilogue(has_scale_a=True))
    with pytest.raises(ValueError):
        gm_ops.grouped_matmul(x, torch.zeros(3, 4, 6))


class _FakeCuda(torch.Tensor):
    """A CPU tensor that says it lies on a CUDA card."""

    @property
    def is_cuda(self):
        return True


def test_grouped_matmul_raises_instead_of_falling_back(monkeypatch):
    from repro_torch.kernels.moe import grouped_matmul as gm

    def fail(*args, **kwargs):
        raise RuntimeError("grouped_matmul kernel launch failed: CUDA "
                           "error 700")
    monkeypatch.setattr(gm_ops, "grouped_matmul_cuda", fail)
    x = torch.Tensor._make_subclass(_FakeCuda, torch.ones(2, 3, 4))
    before = gm_ops.grouped_matmul.launches
    with pytest.raises(RuntimeError, match="error 700"):
        gm_ops.grouped_matmul(x, torch.ones(2, 4, 6))
    assert gm_ops.grouped_matmul.launches == before
    # A launch that returns a CUDA error raises too, on every tile.
    for launcher in ("_launcher", "_decode_launcher", "_tc_launcher"):
        monkeypatch.setattr(gm, launcher, lambda: lambda *a: 700)

    class _Stream:
        cuda_stream = None
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    for c, dt, tile in ((3, torch.float32, "decode"),
                        (9, torch.float32, "simt"),
                        (16, torch.bfloat16, "tc")):
        x, w = torch.ones(2, c, 16, dtype=dt), torch.ones(2, 16, 8, dtype=dt)
        ep = Epilogue(out_dtype=dt)
        assert gm.tile_for(x, w, ep) == tile
        with pytest.raises(RuntimeError, match=f"{tile} tile.*CUDA error 700"):
            gm.grouped_matmul_cuda(x, w, ep)


def test_grouped_matmul_checks_rows_and_ignores_them_on_the_cpu():
    """``rows`` is int32 of shape (E,) on x's device; the plain version
    computes the same function without it."""
    x = torch.randn(3, 5, 8)
    x[0, 2:] = 0
    x[1] = 0
    w = torch.randn(3, 8, 6)
    rows = torch.tensor([2, 0, 5], dtype=torch.int32)
    torch.testing.assert_close(
        gm_ops.grouped_matmul(x, w, rows=rows, max_rows=5, max_experts=2),
        gm_ops.grouped_matmul(x, w), rtol=0, atol=0)
    for bad in (rows.long(), rows[:2], torch.zeros(1, 3, dtype=torch.int32)):
        with pytest.raises(ValueError, match="rows must be int32"):
            gm_ops.grouped_matmul(x, w, rows=bad)


@pytest.mark.parametrize("activation", sorted(ACTIVATIONS))
@pytest.mark.parametrize("glu", [False, True])
def test_keeps_zero_rows_walks_every_activation(activation, glu):
    """The rule that decides whether the second expert GEMM may take the
    first one's ``rows``: true exactly where the epilogue maps a zero
    accumulator to zero (all but sigmoid without GLU)."""
    ep = Epilogue(activation=activation, glu=glu, softcap=5.0,
                  out_dtype=torch.float32)
    zero = apply_epilogue(torch.zeros(2, 4), ep, NO_OPERANDS)
    assert gm_ops.keeps_zero_rows(ep) == bool((zero == 0).all())
    assert gm_ops.keeps_zero_rows(ep) == (glu or activation != "sigmoid")


# ---------------------------------------------------------------------------
# Dispatch and combine.
# ---------------------------------------------------------------------------

def _capture(monkeypatch, module, store):
    """Record the (E, C, d) buffer each call hands to ``_expert_ffn``."""
    inner = module._expert_ffn

    def spy(cfg, wi, wo, x, *args):
        store.append(np.asarray(x))
        return inner(cfg, wi, wo, x, *args)
    monkeypatch.setattr(module, "_expert_ffn", spy)


def _holding_promises(monkeypatch, calls):
    """Make every grouped call check the promises it is handed against
    its ``x`` (rows[e] tight: the rows before it are tokens, the rows from
    it zero) and compute as the kernel does, on the rows below them only;
    record (rows, max_rows, max_experts) of each call."""
    inner = gm_ops.grouped_matmul

    def holding(x, w, *, epilogue=Epilogue(), rows=None, max_rows=None,
                max_experts=None):
        calls.append((rows, max_rows, max_experts))
        if rows is not None:
            live = torch.arange(x.shape[1])[None, :] < rows[:, None].long()
            nonzero = (x != 0).any(-1)
            assert torch.equal(nonzero, live)
            assert int(rows.max()) <= max_rows
            assert int((rows > 0).sum()) <= max_experts
            x = torch.where(live[..., None], x, 0)
        return inner(x, w, epilogue=epilogue)
    monkeypatch.setattr(gm_ops, "grouped_matmul", holding)


@pytest.mark.parametrize("port_route", ["kernel", "torch", "kernel-rows"])
@pytest.mark.parametrize("capacity", ["T*k", 2])
def test_moe_apply_local_matches_jax(monkeypatch, capacity, port_route):
    """``kernel-rows``: the kernel route with each grouped call holding
    the zero-row promises the layer makes and computing on the promised
    rows alone."""
    calls = []
    if port_route == "kernel-rows":
        _holding_promises(monkeypatch, calls)
        port_route = "kernel"
    jcfg, tcfg = _cfgs("olmoe-1b-7b", port_route=port_route)
    jp = j_moe.moe_init(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    t = 64
    x = _rng(7).standard_normal((t, jcfg.d_model)).astype(np.float32)
    cap = t * jcfg.moe.top_k if capacity == "T*k" else capacity
    jbuf, tbuf = [], []
    _capture(monkeypatch, j_moe, jbuf)
    _capture(monkeypatch, moe, tbuf)
    ref = j_moe.moe_apply_local(jcfg, jnp.asarray(x), jp["w_router"],
                                jp["experts_wi"], jp["experts_wo"], 0, cap)
    out = moe.moe_apply_local(tcfg, torch.from_numpy(x), tp["w_router"],
                              tp["experts_wi"], tp["experts_wo"], 0, cap)
    _, j_idx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ jp["w_router"]),
                             jcfg.moe.top_k)
    _, t_idx = moe.route(tcfg, torch.from_numpy(x), tp["w_router"])
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    # Same dispatched (E, C, d) buffer, row for row: every slot is the
    # same, and so is every dropped token.
    assert tbuf[0].shape == (jcfg.moe.n_experts, cap, jcfg.d_model)
    np.testing.assert_array_equal(tbuf[0], jbuf[0])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    if calls:     # both GEMMs took the promises: GLU keeps zero rows zero
        assert len(calls) == 2 and calls[0] == calls[1]
        assert calls[0][1:] == (min(cap, t), min(jcfg.moe.n_experts,
                                                 t * jcfg.moe.top_k))


def test_expert_windows_sum_to_the_whole():
    _, tcfg = _cfgs("olmoe-1b-7b")
    p = moe.moe_init(tcfg, torch.Generator().manual_seed(1))
    x = torch.from_numpy(_rng(8).standard_normal((32, tcfg.d_model))
                         .astype(np.float32))
    cap = 32 * tcfg.moe.top_k
    full = moe.moe_apply_local(tcfg, x, p["w_router"], p["experts_wi"],
                               p["experts_wo"], 0, cap)
    half = tcfg.moe.n_experts // 2
    parts = sum(moe.moe_apply_local(tcfg, x, p["w_router"],
                                    p["experts_wi"][s:s + half],
                                    p["experts_wo"][s:s + half], s, cap)
                for s in (0, half))
    torch.testing.assert_close(parts, full, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_capacity_matches_jax(arch, reduced):
    jcfg = j_get_config(arch, reduced=reduced)
    tcfg = get_config(arch, reduced=reduced)
    for t in list(range(1, 300)) + [360, 884, 4096, 65536]:
        assert moe.moe_capacity(tcfg, t) == j_moe.moe_capacity(jcfg, t)
    assert moe.moe_capacity(get_config("olmoe-1b-7b"), 884) == 144


def test_moe_init_draws_the_reference_distributions():
    _, tcfg = _cfgs("arctic-480b")
    tcfg = tcfg.with_(d_model=256)
    p = moe.moe_init(tcfg, torch.Generator().manual_seed(0))
    m = tcfg.moe
    assert p["w_router"].dtype == torch.float32
    assert tuple(p["experts_wi"].shape) == (m.n_experts, 256,
                                            2 * m.d_ff_expert)
    # The reference divides experts_wi by sqrt(n_experts) (in_axis 0),
    # experts_wo and dense_wo by sqrt(d_model) (in_axis 2 and 1).
    for name, fan_in in (("experts_wi", m.n_experts), ("experts_wo", 256),
                         ("w_router", 256), ("dense_wi", 256),
                         ("dense_wo", 256)):
        std = p[name].float().std().item()
        assert abs(std * fan_in ** 0.5 - 1.0) < 0.05, (name, std)


# ---------------------------------------------------------------------------
# Reduced OLMoE and Arctic end to end.
# ---------------------------------------------------------------------------

def _close(out, ref, tol=1e-4):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref),
                               rtol=tol, atol=tol)


def test_params_from_jax_walks_the_moe_subtree(model):
    arch, jparams, tparams = model
    _, tcfg = _cfgs(arch)
    ours = tt.init(tcfg, torch.Generator().manual_seed(0))
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    moe_leaves = [p for p, _ in flat if any(
        getattr(k, "key", None) == "moe" for k in p)]
    assert len(moe_leaves) == (5 if arch == "arctic-480b" else 3)
    for path, leaf in flat:
        a, b = tparams, ours
        for key in path:
            k = getattr(key, "key", getattr(key, "idx", None))
            a, b = a[k], b[k]
        assert tuple(a.shape) == leaf.shape == tuple(b.shape)
        assert a.dtype == b.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(leaf))


@pytest.mark.parametrize("port_route", ["kernel", "torch"])
@pytest.mark.parametrize("jax_route", ["xla", "pallas"])
def test_forward_prefill_decode_match_jax(model, jax_route, port_route):
    arch, jparams, tparams = model
    jcfg, tcfg = _cfgs(arch, jax_route, port_route)
    jmod = j_family(jcfg)
    toks = _rng(1).integers(0, jcfg.vocab_size, (B, S))
    prev = backend.set_default_matmul_backend(port_route)
    try:
        _close(tt.forward(tcfg, tparams, {"tokens": torch.from_numpy(toks)}),
               jmod.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)}))
        jcache = jmod.init_cache(jcfg, B, S + DECODE)
        tcache = tt.init_cache(tcfg, B, S + DECODE)
        jl, jcache = jmod.prefill(jcfg, jparams,
                                  {"tokens": jnp.asarray(toks)}, jcache)
        tl, tcache = tt.prefill(tcfg, tparams,
                                {"tokens": torch.from_numpy(toks)}, tcache)
        _close(tl, jl)
        for i in range(DECODE):
            tok = np.array(jnp.argmax(jl, axis=-1))[:, None]
            jl, jcache = jmod.decode_step(jcfg, jparams, jnp.asarray(tok),
                                          jcache, S + i)
            tl, tcache = tt.decode_step(tcfg, tparams, torch.from_numpy(tok),
                                        tcache, S + i)
            _close(tl, jl)
    finally:
        backend.set_default_matmul_backend(prev)


def test_olmoe_serving_engine_greedy_tokens_identical():
    jcfg, tcfg = _cfgs("olmoe-1b-7b", "pallas", "kernel")
    jparams = j_family(jcfg).init(jcfg, jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    prompts = [_rng(10 + i).integers(0, jcfg.vocab_size, (n,))
               for i, n in enumerate([5, 9, 3, 12])]
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
