"""RWKV-6 on a model axis that splits its heads, against the reference.

Reduced RWKV-6 has 4 heads of 32 channels; on a model axis of 8 a rank's
columns of ``w_r``, ``w_k``, ``w_v`` and ``w_g`` are half a head, and the
reference's ``cache_shardings`` gives the WKV state's key-channel dim to
``model``: a rank's state leaf is (L, B, H, K / 8, V).  The port's rank
gathers r, k and v into whole heads and the state along its key
channels, runs the whole WKV, keeps its key channels' rows of the new
state and its columns of the output (``models/rwkv6.py::time_mix``).

The cases run in two subprocesses on the same numpy inputs, as
``tests/test_torch_rec_mesh.py`` runs its own: the reference on 8 forced
host devices, each step jitted under ``logical.use_rules`` of a (data 1,
model 8) mesh, its params, batch and cache placed by its shardings (its
``xla`` route); the port in a gloo world of 8 CPU ranks
(``launch.mesh.run_world``), serving through ``serving.engine`` and
training through ``training.train_step.make_train_step``, each without
and with ``{"seq": "model"}`` (a prompt of 16 tokens, which the 8 ranks
divide, so that the prefill's stream is sharded).  fp32.  Serving: 4
prompts, a prefill and 2 decode steps; each rank's logits within 1e-5 of
max |logit| of the reference's, greedy identical; the gathered WKV state
and shifts within 1e-5 of their max, the rank's state leaf the shape the
reference's rank holds.  Training: one AdamW step (2 microbatches of 4 x
16 tokens, remat "full", the plain torch route, eps 1e-2 as in
``tests/test_torch_tensor_parallel.py``): the loss within 1e-5 relative,
every gathered first moment (the gradient) within 1e-4 of its max.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.models.base import family_module as j_family   # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
WORLD_TIMEOUT = 300          # seconds, each subprocess
ARCH = "rwkv6-7b"
MESH = (1, 8)
#: case -> rules
CASES = {"heads": None, "seq": {"seq": "model"}}
B, S, STEPS, CACHE_LEN = 4, 16, 2, 32
TRAIN_B, TRAIN_S, MB = 8, 16, 2
OPT = dict(lr=3e-4, warmup_steps=1, total_steps=10, eps=1e-2)
#: logits and the gathered cache, of max |logit| and of a leaf's max
TOL_SERVE = 1e-5
#: a gathered first moment, of its leaf's max
TOL_GRAD = 1e-4

_REFERENCE_PROG = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys
    sys.path.insert(0, sys.argv[1])
    import json
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import AxisType
    from repro.configs.registry import get_config
    from repro.distributed import logical, sharding
    from repro.models.base import family_module
    from repro.optim import adamw
    from repro.training.train_step import TrainConfig, make_train_step

    tmp = sys.argv[2]
    spec = json.load(open(os.path.join(tmp, "cases.json")))
    inp = dict(np.load(os.path.join(tmp, "inputs.npz")))
    out = {}
    cfg = get_config(spec["arch"], reduced=True).with_(
        dtype=jnp.float32, kv_cache_dtype=jnp.float32)
    mod = family_module(cfg)
    like = jax.eval_shape(lambda k: mod.init(cfg, k), jax.random.PRNGKey(0))
    n = len(jax.tree.leaves(like))

    def load():
        return jax.tree.unflatten(jax.tree.structure(like), [
            jnp.asarray(inp[f"param/{i:03d}"]) for i in range(n)])

    mesh = jax.make_mesh(tuple(spec["mesh"]), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:8])
    s = spec["s"]
    tcfg = TrainConfig(optimizer=adamw.AdamWConfig(**spec["opt"]),
                       microbatches=spec["mb"], loss_chunk=8)
    train_cfg = cfg.with_(remat="full")
    for case, rules in spec["cases"].items():
        with logical.use_rules(mesh, rules):
            params = load()
            params = sharding.apply_shardings(
                params, sharding.param_shardings(params, mesh, rules))
            batch = {"tokens": jnp.asarray(inp["tokens"][:, :s])}
            batch = sharding.apply_shardings(
                batch, sharding.batch_shardings(batch, mesh, rules))
            cache = mod.init_cache(cfg, spec["batch"], spec["cache_len"])
            cache = sharding.apply_shardings(
                cache, sharding.cache_shardings(cache, mesh, cfg, rules))
            for j, leaf in enumerate(jax.tree.leaves(cache)):
                out[f"{case}/held/{j}"] = np.array(
                    leaf.addressable_shards[0].data.shape)
            prefill = jax.jit(lambda p, b, c: mod.prefill(cfg, p, b, c))
            decode = jax.jit(lambda p, t, c, i: mod.decode_step(cfg, p, t,
                                                                c, i))
            logits, cache = prefill(params, batch, cache)
            out[f"{case}/logits/0"] = np.asarray(logits)
            for i in range(spec["steps"]):
                logits, cache = decode(params, jnp.asarray(
                    inp["tokens"][:, s + i:s + i + 1]), cache,
                    jnp.int32(s + i))
                out[f"{case}/logits/{i + 1}"] = np.asarray(logits)
            for j, leaf in enumerate(jax.tree.leaves(cache)):
                out[f"{case}/cache/{j}"] = np.asarray(leaf)
            tb = {k: jnp.asarray(inp[f"train/{k}"])
                  for k in ("tokens", "labels")}
            tb = sharding.apply_shardings(
                tb, sharding.batch_shardings(tb, mesh, rules))
            opt = adamw.init(tcfg.optimizer, params)
            _, o, m, _ = jax.jit(make_train_step(train_cfg, tcfg))(
                params, opt, tb)
            out[f"{case}/loss"] = np.asarray(m["loss"])
            for i, x in enumerate(jax.tree.leaves(o["mu"])):
                out[f"{case}/mu/{i:03d}"] = np.asarray(x)
    np.savez(os.path.join(tmp, "reference.npz"), **out)
""")

_PORT_PROG = textwrap.dedent("""
    import os
    import sys
    sys.path.insert(0, sys.argv[1])
    import json
    import numpy as np
    import torch

    from repro_torch.launch.mesh import run_world


    def rank_main(world, tmp):
        torch.set_num_threads(1)
        from repro_torch.configs.registry import get_config
        from repro_torch.core import tree
        from repro_torch.distributed import logical, sharding
        from repro_torch.kernels.rwkv6 import ops as wkv_ops
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.base import family_module
        from repro_torch.optim import adamw
        from repro_torch.serving.engine import make_decode, make_prefill
        from repro_torch.training.train_step import (TrainConfig,
                                                     make_train_step)

        spec = json.load(open(os.path.join(tmp, "cases.json")))
        inp = {k: torch.from_numpy(v) for k, v in
               np.load(os.path.join(tmp, "inputs.npz")).items()}
        calls = [0]
        inner = wkv_ops.rwkv6_scan

        def rwkv6_scan(*args, **kw):      # K6's wrapper, its calls counted
            calls[0] += 1
            return inner(*args, **kw)
        wkv_ops.rwkv6_scan = rwkv6_scan
        mesh = make_mesh(tuple(spec["mesh"]), ("data", "model"))
        cfg = get_config(spec["arch"], reduced=True).with_(
            dtype=torch.float32, kv_cache_dtype=torch.float32)
        mod = family_module(cfg)
        like = mod.init(cfg, None, "meta")
        s = spec["s"]
        out = {}

        def load():
            # copies: a leaf the rules keep whole is its own shard, and a
            # train step writes into it
            return tree.unflatten(like, [
                inp[f"param/{i:03d}"].clone()
                for i in range(len(tree.leaves(like)))])

        tcfg = TrainConfig(optimizer=adamw.AdamWConfig(**spec["opt"]),
                           microbatches=spec["mb"], loss_chunk=8)
        train_cfg = cfg.with_(remat="full", backend="torch")
        for case, rules in spec["cases"].items():
            params = load()
            local = sharding.shard_params(params, mesh, rules,
                                          glu=cfg.mlp_glu)
            cache = sharding.shard_cache(mod.init_cache(
                cfg, spec["batch"], spec["cache_len"]), mesh, cfg, rules)
            for j, leaf in enumerate(tree.leaves(cache)):
                out[f"{case}/held/{j}"] = np.array(leaf.shape)
            before = calls[0]
            with logical.use_rules(mesh, rules):
                batch = sharding.local_batch(
                    {"tokens": inp["tokens"][:, :s]}, mesh)
                logits, cache = make_prefill(cfg)(local, batch, cache)
                out[f"{case}/logits/0"] = logits
                for i in range(spec["steps"]):
                    logits, cache = make_decode(cfg)(
                        local, inp["tokens"][:, s + i:s + i + 1], cache,
                        s + i)
                    out[f"{case}/logits/{i + 1}"] = logits
            out[f"{case}/wkv_calls"] = np.array(calls[0] - before)
            whole = sharding.gather_cache(cache, mesh, cfg, rules)
            for j, leaf in enumerate(tree.leaves(whole)):
                out[f"{case}/cache/{j}"] = leaf
            opt = adamw.init(tcfg.optimizer, local)
            with logical.use_rules(mesh, rules):
                lb = sharding.local_batch(
                    {"tokens": inp["train/tokens"],
                     "labels": inp["train/labels"]}, mesh, spec["mb"])
                _, o, m, _ = make_train_step(train_cfg, tcfg)(local, opt, lb)
                mu = sharding.gather_params(o["mu"], like, mesh, rules,
                                            glu=cfg.mlp_glu)
            out[f"{case}/loss"] = m["loss"]
            for i, x in enumerate(tree.leaves(mu)):
                out[f"{case}/mu/{i:03d}"] = x
        np.savez(os.path.join(tmp, f"rank{world.rank}.npz"),
                 **{k: np.asarray(v) for k, v in out.items()})


    if __name__ == "__main__":
        run_world(rank_main, 8, (sys.argv[2],), device="cpu",
                  rendezvous=os.path.join(sys.argv[2], "rendezvous"),
                  timeout=float(sys.argv[3]))
""")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """(the reference's results, each port rank's results)."""
    tmp = str(tmp_path_factory.mktemp("rwkv_split_heads"))
    cfg = j_get_config(ARCH, reduced=True).with_(dtype=jnp.float32)
    assert (cfg.n_heads, cfg.rwkv.head_size) == (4, 32)
    params = j_family(cfg).init(cfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(21)
    inp = {f"param/{j:03d}": np.asarray(leaf)
           for j, leaf in enumerate(jax.tree.leaves(params))}
    inp["tokens"] = rng.integers(0, cfg.vocab_size,
                                 (B, S + STEPS)).astype(np.int32)
    toks = rng.integers(0, cfg.vocab_size,
                        (TRAIN_B, TRAIN_S + 1)).astype(np.int32)
    inp["train/tokens"], inp["train/labels"] = toks[:, :-1], toks[:, 1:]
    np.savez(os.path.join(tmp, "inputs.npz"), **inp)
    with open(os.path.join(tmp, "cases.json"), "w") as f:
        json.dump({"arch": ARCH, "mesh": MESH, "cases": CASES, "batch": B,
                   "s": S, "steps": STEPS, "cache_len": CACHE_LEN,
                   "opt": OPT, "mb": MB}, f)
    prog = os.path.join(tmp, "port_world.py")
    with open(prog, "w") as f:
        f.write(_PORT_PROG)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    procs = {
        "reference": subprocess.Popen(
            [sys.executable, "-c", _REFERENCE_PROG, os.path.abspath(SRC),
             tmp], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True),
        "port": subprocess.Popen(
            [sys.executable, prog, os.path.abspath(SRC), tmp,
             str(WORLD_TIMEOUT - 30)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)}
    errors = {}
    for name, proc in procs.items():
        try:
            _, err = proc.communicate(timeout=WORLD_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
            errors[name] = f"timed out after {WORLD_TIMEOUT} s\n{err[-3000:]}"
            continue
        if proc.returncode != 0:
            errors[name] = f"rc {proc.returncode}\n{err[-3000:]}"
    assert not errors, errors
    ref = dict(np.load(os.path.join(tmp, "reference.npz")))
    ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
             for r in range(8)]
    return ref, ranks


def _leaves(out, prefix):
    keys = sorted(k for k in out if k.startswith(prefix))
    return [out[k] for k in keys]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("case", list(CASES))
def test_logits_match_reference_meshed(worlds, case):
    """Each rank's prefill and decode logits (every row: data is 1)
    within 1e-5 of max |logit| of the reference's meshed ones, greedy
    identical."""
    ref, ranks = worlds
    for out in ranks:
        for i in range(STEPS + 1):
            want, got = ref[f"{case}/logits/{i}"], out[f"{case}/logits/{i}"]
            assert got.shape == want.shape
            assert _rel(got, want) <= TOL_SERVE
            np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("case", list(CASES))
def test_state_matches_reference(worlds, case):
    """The cache gathered from every rank's shards after the prefill and
    the decode steps (the shifts, and the WKV state from each rank's key
    channels) within 1e-5 of the reference's, leaf by leaf; each rank
    held the leaf the reference's rank holds: (L, B, H, 32 / 8, 32) for
    the state."""
    ref, ranks = worlds
    cfg = j_get_config(ARCH, reduced=True)
    held = [tuple(ref[f"{case}/held/{j}"]) for j in range(3)]
    assert (cfg.n_layers, B, 4, 4, 32) in held
    for out in ranks:
        assert [tuple(out[f"{case}/held/{j}"]) for j in range(3)] == held
        for j in range(3):
            want, got = ref[f"{case}/cache/{j}"], out[f"{case}/cache/{j}"]
            assert got.shape == want.shape
            assert _rel(got, want) <= TOL_SERVE, j


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_runs_the_wkv_kernel_once_a_layer(worlds, case):
    """On the kernel route each rank's prefill calls K6's wrapper (its
    plain version on CPU tensors) once a layer, on every head; the
    decode steps take the one-token oracle."""
    _, ranks = worlds
    n = j_get_config(ARCH, reduced=True).n_layers
    assert all(int(out[f"{case}/wkv_calls"]) == n for out in ranks)


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_reference_meshed(worlds, case):
    """Every rank's loss within 1e-5 relative and each gathered first
    moment within 1e-4 of its max, against the reference's step jitted
    under the same mesh and rules."""
    ref, ranks = worlds
    loss = float(ref[f"{case}/loss"])
    want = _leaves(ref, f"{case}/mu/")
    for out in ranks:
        assert abs(float(out[f"{case}/loss"]) - loss) <= 1e-5 * abs(loss)
        got = _leaves(out, f"{case}/mu/")
        assert len(got) == len(want) > 0
        worst = max((_rel(a, b), i) for i, (a, b) in enumerate(zip(got,
                                                                   want)))
        assert worst[0] <= TOL_GRAD, worst
