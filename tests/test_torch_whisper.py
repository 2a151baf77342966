"""The port's whisper-tiny against the reference's, on the same weights.

The reference's params are carried across with ``params_from_jax``; the
audio embeddings (the stub frontend's output) are seeded and differ by
batch row, so a row mixed up in the encoder or in the cross-attention
shows.  fp32, reduced and at full width (4 + 4 layers, d=384, 1500
audio frames): ``forward``, ``prefill`` and three decode steps within
rtol/atol 1e-4, as the other families are held, on both port routes
(``kernel``, which is the kernels' plain versions here, and ``torch``);
``ServingEngine.run`` gives identical greedy tokens; the launcher serves
``--arch whisper-tiny``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.models import whisper as jw                     # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch import backend                          # noqa: E402
from repro_torch.configs.registry import get_config      # noqa: E402
from repro_torch.launch import serve                     # noqa: E402
from repro_torch.models import whisper as tw             # noqa: E402
from repro_torch.models.base import family_module        # noqa: E402
from repro_torch.models.convert import params_from_jax   # noqa: E402
from repro_torch.serving.engine import ServingEngine     # noqa: E402

B, S, DECODE = 2, 6, 3


def _cfgs(reduced):
    jcfg = j_get_config("whisper-tiny", reduced=reduced).with_(
        remat="none", dtype=jnp.float32, kv_cache_dtype=jnp.float32)
    tcfg = get_config("whisper-tiny", reduced=reduced).with_(
        dtype=torch.float32, kv_cache_dtype=torch.float32)
    return jcfg, tcfg


def _model(reduced):
    jcfg, tcfg = _cfgs(reduced)
    jparams = jw.init(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def reduced_model():
    return _model(True)


@pytest.fixture(scope="module")
def full_model():
    return _model(False)


def _batch(cfg, seed):
    """Prompt tokens and audio embeddings, seeded, different by row."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    audio = rng.standard_normal(
        (B, cfg.encdec.n_audio_ctx, cfg.d_model)).astype(np.float32)
    return toks, audio


def _close(out, ref, tol=1e-4):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref),
                               rtol=tol, atol=tol)


def test_params_carry_across_with_the_same_structure(reduced_model):
    jcfg, tcfg, jparams, tparams = reduced_model
    ours = tw.init(tcfg, torch.Generator().manual_seed(0))
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == 33
    for path, leaf in flat:
        a, b = tparams, ours
        for key in path:
            k = getattr(key, "key", getattr(key, "idx", None))
            a, b = a[k], b[k]
        assert tuple(a.shape) == leaf.shape == tuple(b.shape)
        assert a.dtype == b.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(leaf))
    assert family_module(tcfg) is tw


def _hold(jcfg, tcfg, jparams, tparams, port_route, seed):
    """forward, prefill, DECODE decode steps and both caches against the
    reference, the reference on its XLA route."""
    tcfg = tcfg.with_(backend=port_route)
    toks, audio = _batch(jcfg, seed)
    jb = {"tokens": jnp.asarray(toks), "audio_embeds": jnp.asarray(audio)}
    tb = {"tokens": torch.from_numpy(toks),
          "audio_embeds": torch.from_numpy(audio)}
    prev = backend.set_default_matmul_backend(port_route)
    try:
        _close(tw.forward(tcfg, tparams, tb), jw.forward(jcfg, jparams, jb))
        jcache = jw.init_cache(jcfg, B, S + DECODE)
        tcache = tw.init_cache(tcfg, B, S + DECODE)
        jl, jcache = jw.prefill(jcfg, jparams, jb, jcache)
        tl, tcache = tw.prefill(tcfg, tparams, tb, tcache)
        _close(tl, jl)
        for i in range(DECODE):
            tok = np.array(jnp.argmax(jl, axis=-1))[:, None]
            jl, jcache = jw.decode_step(jcfg, jparams, jnp.asarray(tok),
                                        jcache, S + i)
            tl, tcache = tw.decode_step(tcfg, tparams,
                                        torch.from_numpy(tok), tcache,
                                        S + i)
            _close(tl, jl)
        for part in ("self", "cross"):
            for t, j in zip(tcache[part], jcache[part]):
                _close(t, j)
    finally:
        backend.set_default_matmul_backend(prev)


@pytest.mark.parametrize("port_route", ["kernel", "torch"])
def test_reduced_forward_prefill_decode_match_jax(reduced_model,
                                                  port_route):
    _hold(*reduced_model, port_route, seed=1)


def test_reduced_matches_jax_pallas_attention(reduced_model):
    """The reference with its Pallas flash attention (interpret mode)."""
    jcfg, tcfg, jparams, tparams = reduced_model
    _hold(jcfg.with_(backend="pallas"), tcfg, jparams, tparams, "kernel",
          seed=2)


@pytest.mark.parametrize("port_route", ["kernel", "torch"])
def test_full_width_forward_prefill_decode_match_jax(full_model,
                                                     port_route):
    jcfg, tcfg, _, _ = full_model
    assert (tcfg.d_model, tcfg.n_layers, tcfg.encdec.n_encoder_layers,
            tcfg.encdec.n_audio_ctx) == (384, 4, 4, 1500)
    _hold(*full_model, port_route, seed=3)


def test_full_width_parameter_count(full_model):
    jcfg, tcfg, jparams, tparams = full_model
    n = sum(x.numel() for x in jax.tree_util.tree_leaves(
        tparams, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert n == sum(np.asarray(x).size
                    for x in jax.tree_util.tree_leaves(jparams))
    assert tcfg.param_count() == jcfg.param_count()


def test_serving_engine_greedy_tokens_identical(reduced_model):
    """``run`` feeds zero audio embeddings, as the reference's does."""
    jcfg, tcfg, jparams, tparams = reduced_model
    lengths = [5, 9, 3, 12]
    prompts = [np.random.default_rng(10 + i).integers(0, jcfg.vocab_size, n)
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


def test_launcher_serves_whisper_on_cpu(capsys):
    serve.main(["--arch", "whisper-tiny", "--reduced", "--device", "cpu",
                "--requests", "2", "--max-new", "3"])
    assert "served 2 requests, 6 tokens on cpu" in capsys.readouterr().out
