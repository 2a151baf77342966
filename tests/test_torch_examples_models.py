"""The port's model examples against the reference's, on the CPU:
``serve_batched`` and ``train_lm``.

``serve_batched_torch.serve`` takes the reference's own parameters and
prompts (its ``jax.random`` draws, carried across through numpy) and must
give the reference ``ServingEngine``'s greedy tokens exactly, in fp32, on
both of the port's routes.  ``train_lm_torch.train`` (``--small``) starts
from the reference's parameters on the reference's stream and must give
its losses over 3 steps within 1e-5 of each loss, the train-step
tolerance of ``tests/test_torch_training.py``; a resume from its
checkpoint takes the uninterrupted run's steps bit for bit.
"""

import functools
import importlib.util
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig       # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM     # noqa: E402
from repro.models.base import family_module as j_family         # noqa: E402
from repro.optim import adamw as j_adamw                         # noqa: E402
from repro.serving.engine import ServingEngine as JEngine       # noqa: E402
from repro.training import train_step as j_train_step           # noqa: E402
from repro_torch.core import tree                               # noqa: E402
from repro_torch.models.convert import params_from_jax, to_torch  # noqa

ROOT = Path(__file__).resolve().parents[1]

#: a train step's loss, relative (tests/test_torch_training.py)
TOL_TRAIN_LOSS = 1e-5


@functools.cache
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _example(name):
    """``examples/<name>.py`` as a module, by ``chip_smoke.py``'s loader."""
    return _chip_smoke().example_module(name)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


# ---------------------------------------------------------------------------
# serve_batched
# ---------------------------------------------------------------------------

def _reference_serve(arch, n_requests=5, max_new=12):
    """``serve_batched.py``'s ``serve`` without the printing: (params,
    prompts, greedy tokens a request)."""
    cfg = j_get_config(arch, reduced=True).with_(
        dtype=jnp.float32, remat="none", kv_cache_dtype=jnp.float32)
    params = j_family(cfg).init(cfg, jax.random.PRNGKey(0))
    eng = JEngine(cfg, params, max_batch=4, cache_len=128)
    key, prompts = jax.random.PRNGKey(1), []
    for i in range(n_requests):
        key, sub = jax.random.split(key)
        prompts.append(jax.random.randint(sub, (4 + (i * 5) % 10,), 0,
                                          cfg.vocab_size))
        eng.submit(prompts[-1])
    outs = eng.run(max_new_tokens=max_new)
    return params, prompts, [np.asarray(o) for o in outs]


@pytest.mark.parametrize("arch", ["yi-6b", "rwkv6-7b", "recurrentgemma-2b"])
def test_serve_batched_greedy_tokens_equal_reference(arch):
    ex = _example("serve_batched_torch")
    assert arch in ex.ARCHS
    jparams, jprompts, ref = _reference_serve(arch)
    params = params_from_jax(_np_tree(jparams))
    prompts = [to_torch(p) for p in jprompts]
    for route in ("kernel", "torch"):
        outs = ex.serve(arch, params, prompts, route=route, verbose=False)
        assert len(outs) == len(ref) == 5
        for o, r in zip(outs, ref):
            np.testing.assert_array_equal(o.numpy(), r)


def test_serve_batched_main_prints_the_reference_lines(capsys):
    """``--device cpu``: a line a model in the reference's form, then its
    first three requests' tokens; 5 requests of 12 new tokens each."""
    ex = _example("serve_batched_torch")
    got = ex.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert list(got) == list(ex.ARCHS)
    assert len(lines) == 4 * len(ex.ARCHS)
    for i, arch in enumerate(ex.ARCHS):
        head = lines[4 * i]
        assert head.startswith(f"[{arch}] 5 requests, 60 new tokens, ")
        assert head.endswith(" tok/s)")
        for j in range(3):
            assert lines[4 * i + 1 + j] == \
                f"   req{j} -> {list(map(int, got[arch][j]))}"
        assert [o.shape for o in got[arch]] == [(12,)] * 5


# ---------------------------------------------------------------------------
# train_lm
# ---------------------------------------------------------------------------

def test_train_lm_configs_equal_reference():
    ref_ex, ex = _example("train_lm"), _example("train_lm_torch")
    for small in (True, False):
        jcfg, cfg = ref_ex.build_config(small), ex.build_config(small)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.padded_vocab == jcfg.padded_vocab
        for k in ("n_layers", "d_model", "n_heads", "n_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "remat", "attn_chunk"):
            assert getattr(cfg, k) == getattr(jcfg, k)


def test_train_lm_small_losses_equal_reference(tmp_path):
    """``--small`` over 3 steps from the reference's parameters on its
    stream: each loss within TOL_TRAIN_LOSS of the reference's."""
    steps, batch, seq = 3, 8, 64
    ref_ex, ex = _example("train_lm"), _example("train_lm_torch")
    jcfg = ref_ex.build_config(True)
    jt = j_train_step.TrainConfig(
        optimizer=j_adamw.AdamWConfig(lr=3e-3, total_steps=steps,
                                      warmup_steps=max(steps // 20, 1)),
        loss_chunk=min(256, seq))
    step_fn = jax.jit(j_train_step.make_train_step(jcfg, jt))
    data = JSyntheticLM(JDataConfig(vocab_size=jcfg.vocab_size,
                                    global_batch=batch, seq_len=seq))
    params = j_family(jcfg).init(jcfg, jax.random.PRNGKey(0))
    ours = params_from_jax(_np_tree(params))
    opt = j_adamw.init(jt.optimizer, params)
    ref = []
    for _ in range(steps):
        params, opt, metrics, _ = step_fn(params, opt, next(data))
        ref.append(float(metrics["loss"]))

    run = ex.train(ex.build_config(True), steps=steps, global_batch=batch,
                   seq_len=seq, ckpt_dir=str(tmp_path / "ckpt"),
                   device="cpu", params=ours)
    assert run.start == 0 and len(run.losses) == steps
    np.testing.assert_allclose(run.losses, ref, rtol=TOL_TRAIN_LOSS, atol=0)
    assert ref[-1] < ref[0] and run.losses[-1] < run.losses[0]


def test_train_lm_resumes_bit_for_bit(tmp_path, capsys):
    """A run to 6 steps with a checkpoint every 3, then the step-6
    checkpoint removed: the rerun resumes from step 3 and takes steps 3-5
    as the first run took them."""
    ex = _example("train_lm_torch")
    cfg = ex.build_config(True)
    kw = dict(steps=6, global_batch=4, seq_len=32,
              ckpt_dir=str(tmp_path / "ckpt"), device="cpu", ckpt_every=3)
    first = ex.train(cfg, **kw)
    assert first.steps == [3, 6]
    shutil.rmtree(tmp_path / "ckpt" / "step_00000006")
    again = ex.train(cfg, **kw)
    assert again.start == 3
    assert "resumed from step 3" in capsys.readouterr().out
    assert again.losses == first.losses[3:]
    for a, b in zip(tree.leaves((again.params, again.opt)),
                    tree.leaves((first.params, first.opt))):
        assert torch.equal(a, b)


def test_train_lm_main_small(tmp_path, capsys):
    ex = _example("train_lm_torch")
    run = ex.main(["--small", "--steps", "2", "--device", "cpu",
                   "--ckpt-dir", str(tmp_path / "ckpt")])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "model: 0.1M params (2L d=64 vocab=512)"
    assert lines[1].startswith("step    0  loss ")
    assert lines[-1] == (f"final loss {run.losses[-1]:.4f} (started "
                         f"{run.losses[0]:.4f}); checkpoints at "
                         f"{tmp_path / 'ckpt'}: steps []")
