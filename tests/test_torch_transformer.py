"""The port's reduced yi-6b against the reference's, on the same weights.

The reference's params are carried across with ``params_from_jax``.
fp32: ``forward``, ``prefill`` and decode steps within rtol/atol 1e-4
under both reference attention routes (``xla`` and ``pallas``) and both
port routes (``kernel``, which is the kernels' plain versions here, and
``torch``); ``ServingEngine.run`` gives identical greedy tokens.  bf16:
2e-2 relative to max |logit|."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.models.base import family_module as j_family  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch import backend                          # noqa: E402
from repro_torch.configs.registry import get_config      # noqa: E402
from repro_torch.launch import serve                     # noqa: E402
from repro_torch.models import common as cm              # noqa: E402
from repro_torch.models import transformer as tt         # noqa: E402
from repro_torch.models.base import ArchConfig, family_module  # noqa: E402
from repro_torch.models.convert import params_from_jax   # noqa: E402
from repro_torch.serving.engine import ServingEngine, generate  # noqa: E402

B, S, DECODE = 2, 12, 3


def _cfgs(jax_dtype=jnp.float32, torch_dtype=torch.float32):
    jcfg = j_get_config("yi-6b", reduced=True).with_(
        remat="none", dtype=jax_dtype, kv_cache_dtype=jax_dtype)
    tcfg = get_config("yi-6b", reduced=True).with_(
        dtype=torch_dtype, kv_cache_dtype=torch_dtype)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def fp32_model():
    jcfg, tcfg = _cfgs()
    jparams = j_family(jcfg).init(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _close(out, ref, tol=1e-4):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref),
                               rtol=tol, atol=tol)


def test_params_carry_across_with_the_same_structure(fp32_model):
    jcfg, tcfg, jparams, tparams = fp32_model
    ours = tt.init(tcfg, torch.Generator().manual_seed(0))
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == 11
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
def test_forward_prefill_decode_match_jax(fp32_model, jax_route, port_route):
    jcfg, tcfg, jparams, tparams = fp32_model
    jcfg = jcfg.with_(backend=jax_route)
    tcfg = tcfg.with_(backend=port_route)
    jmod = j_family(jcfg)
    toks = _tokens(1, (B, S), jcfg.vocab_size)
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
        for (jk, jv), (tk, tv) in zip(jcache, tcache):
            _close(tk, jk)
            _close(tv, jv)
    finally:
        backend.set_default_matmul_backend(prev)


def test_serving_engine_greedy_tokens_identical(fp32_model):
    jcfg, tcfg, jparams, tparams = fp32_model
    lengths = [5, 9, 3, 12]
    prompts = [_tokens(10 + i, (n,), jcfg.vocab_size)
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
    assert len(teng.results) == 2 and not teng.requests


def _perturbed(params, rng):
    """Norm weights and biases made non-trivial (init leaves them 0/1)."""
    def leaf(path, x):
        name = str(getattr(path[-1], "key", ""))
        if name.startswith("ln") or name.endswith("norm") or name in (
                "bq", "bk", "bv"):
            return x + 0.1 * rng.standard_normal(x.shape).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(leaf, params)


@pytest.mark.parametrize("arch", ["gemma2-2b", "internvl2-1b"])
def test_dense_config_features_match_jax(arch):
    """Sandwich/unit-offset norms, soft-caps, (local, global) windows,
    tied scaled embeddings (gemma2); QKV bias and the vision prefix
    (internvl2): reduced reference configs, carried across field by
    field, through forward, prefill and decode."""
    jcfg = j_get_config(arch, reduced=True).with_(
        remat="none", dtype=jnp.float32, kv_cache_dtype=jnp.float32)
    tcfg = ArchConfig(**{
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ArchConfig)
        if f.name not in ("dtype", "kv_cache_dtype", "backend")}).with_(
            dtype=torch.float32, kv_cache_dtype=torch.float32)
    rng = np.random.default_rng(5)
    jmod = j_family(jcfg)
    jparams = _perturbed(jmod.init(jcfg, jax.random.PRNGKey(2)), rng)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    s = 20                                       # past gemma2's window 16
    toks = _tokens(6, (B, s), jcfg.vocab_size)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if jcfg.vision_prefix:
        vis = rng.standard_normal((B, jcfg.vision_prefix, jcfg.d_model))
        jb["vision_embeds"] = jnp.asarray(vis, jnp.float32)
        tb["vision_embeds"] = torch.from_numpy(vis.astype(np.float32))
    _close(tt.forward(tcfg, tparams, tb), jmod.forward(jcfg, jparams, jb))
    jcache = jmod.init_cache(jcfg, B, s + 2)
    tcache = tt.init_cache(tcfg, B, s + 2)
    jl, jcache = jmod.prefill(jcfg, jparams, jb, jcache)
    tl, tcache = tt.prefill(tcfg, tparams, tb, tcache)
    _close(tl, jl)
    for i in range(2):
        tok = np.array(jnp.argmax(jl, axis=-1))[:, None]
        jl, jcache = jmod.decode_step(jcfg, jparams, jnp.asarray(tok),
                                      jcache, s + i)
        tl, tcache = tt.decode_step(tcfg, tparams, torch.from_numpy(tok),
                                    tcache, s + i)
        _close(tl, jl)


def test_bf16_forward_within_2e2():
    jcfg, tcfg = _cfgs(jnp.bfloat16, torch.bfloat16)
    jparams = j_family(jcfg).init(jcfg, jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    toks = _tokens(2, (B, S), jcfg.vocab_size)
    ref = np.asarray(j_family(jcfg).forward(
        jcfg, jparams, {"tokens": jnp.asarray(toks)}))
    out = tt.forward(tcfg, tparams, {"tokens": torch.from_numpy(toks)})
    assert out.dtype == torch.float32
    err = np.abs(out.numpy() - ref).max() / np.abs(ref).max()
    assert err <= 2e-2, err


def test_generate_greedy_matches_forward_argmax():
    _, tcfg = _cfgs()
    params = tt.init(tcfg, torch.Generator().manual_seed(3))
    prompt = torch.from_numpy(_tokens(4, (2, 8), tcfg.vocab_size))
    res = generate(tcfg, params, {"tokens": prompt}, max_new_tokens=4)
    assert res.tokens.shape == (2, 4) and res.steps == 4
    logits = tt.forward(tcfg, params,
                        {"tokens": torch.cat([prompt, res.tokens], 1)})
    for i in range(4):
        assert torch.equal(res.tokens[:, i], logits[:, 8 + i - 1].argmax(-1))
    assert res.prefill_ms() >= 0 and res.decode_step_ms() >= 0
    sampled = generate(tcfg, params, {"tokens": prompt}, max_new_tokens=3,
                       temperature=1.0,
                       generator=torch.Generator().manual_seed(0))
    assert bool(((sampled.tokens >= 0)
                 & (sampled.tokens < tcfg.padded_vocab)).all())


def test_unported_parts_raise():
    _, tcfg = _cfgs()
    with pytest.raises(NotImplementedError):
        get_config("whisper-tiny")
    with pytest.raises(NotImplementedError):
        family_module(tcfg.with_(family="encdec"))
    with pytest.raises(ValueError):
        cm.cache_update(torch.zeros(1, 1, 4, 2), torch.zeros(1, 1, 4, 2),
                        torch.ones(1, 1, 3, 2), torch.ones(1, 1, 3, 2), 2)
    eng = ServingEngine(tcfg, {"embedding": torch.zeros(1)})
    eng.submit([1, 2], arrival_time=5.0)
    with pytest.raises(ValueError):
        eng.submit([3], arrival_time=1.0)


def test_launcher_serves_on_cpu_and_refuses_unported_modes(capsys):
    serve.main(["--reduced", "--device", "cpu", "--requests", "3",
                "--max-new", "3"])
    out = capsys.readouterr().out
    assert "served 3 requests, 9 tokens on cpu" in out
    serve.main(["--reduced", "--device", "cpu", "--requests", "2",
                "--max-new", "2", "--plan", "desim"])
    out = capsys.readouterr().out
    assert out.startswith("[plan:desim] policy=full-prefill: 2 steps")
    assert "served 2 requests, 4 tokens on cpu" in out
    with pytest.raises(SystemExit):           # the encoder-decoder family
        serve.main(["--arch", "whisper-tiny", "--reduced", "--device",
                    "cpu"])


def test_launcher_serves_olmoe_on_cpu(capsys):
    serve.main(["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
                "--requests", "3", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "served 3 requests, 9 tokens on cpu" in out
