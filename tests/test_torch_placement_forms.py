"""Placements that no experiment's rules give, served and trained on a
rank's shards against the reference under the same rules.

The reference takes any rule dictionary: GSPMD places each leaf by its
name rules and moves the data.  The port's rank brings a block whose
leaves the rules place otherwise than its column/row form to that form
(``tensor_parallel.Placement.reshard``), gathers a dim split over
``model`` and another axis whole (``Placement.param``), runs a block
whose leaves no rule splits over ``model`` whole, gathers a cache's
positions that lie over another axis before it attends, and keeps the
recurrent states of the heads or channels it computes
(``models/rwkv6.py::_state_read``, ``recurrentgemma.rec_split``).

Each case is a configuration, reduced, a mesh and a rule dictionary
(``CASES``): the changes of one key of ``DEFAULT_RULES`` that the port
refused or that crashed, and a named placement for each form no such
change reaches (q heads that straddle KV groups on 3 ranks, a GLU whose
halves do not split, expert leaves split along their d_ff, a cache's
positions or KV heads over the data axis, where a rank's cache holds
other KV heads than it computes).  They run in two subprocesses on the same
numpy inputs, as ``tests/test_torch_rwkv_split_heads.py`` runs its own:
the reference on 4 forced host devices, each step jitted under
``logical.use_rules`` of the case's mesh and rules, its params, batch and
cache placed by its shardings (its ``xla`` route); the port in a gloo
world of 4 CPU ranks (``launch.mesh.run_world``), serving through
``serving.engine`` and training through
``training.train_step.make_train_step`` (a rank outside a 3-rank mesh
sits the case out).  fp32.  Serving: 4 prompts of 16 tokens, a prefill
and 2 decode steps: each rank's logits (its rows) within 1e-5 of max
|logit| of the reference's, greedy identical; the gathered cache within
1e-5 of its max.  Training: one AdamW step (2 microbatches of 8 x 16
tokens, remat "full", eps 1e-2 as in
``tests/test_torch_tensor_parallel.py``): the loss within 1e-5 relative,
every gathered first moment within 1e-4 of its max (Griffin's RG-LRU
decay leaves at 1e-3: torch's expm1 on the CPU,
``tests/test_torch_training.py``'s EXPM1_LEAVES).

This file holds yi-6b's and deepseek-67b's cases; OLMoE's and
Whisper's are in ``tests/test_torch_placement_forms_moe.py``, RWKV-6's
in ``..._rec.py`` and RecurrentGemma's in ``..._griffin.py``, which run
this machinery: each file one pair of worlds of about 80 s.
"""

import json
import os
import subprocess
import sys
import textwrap
import zlib

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.models.base import family_module as j_family   # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
WORLD_TIMEOUT = 300          # seconds, each subprocess
#: case -> (arch, mesh, rules, config overrides; "d_ff_expert" sets the
#: MoE block's)
CASES = {
    "yi/heads=None": ("yi-6b", (2, 2), {"heads": None}, {}),
    "yi/embed=model": ("yi-6b", (2, 2), {"embed": "model"}, {}),
    "yi/mlp=None": ("yi-6b", (2, 2), {"mlp": None}, {}),
    "yi/heads=data,model": ("yi-6b", (2, 2), {"heads": ("data", "model")},
                            {}),
    "yi/vocab=data,model": ("yi-6b", (2, 2), {"vocab": ("data", "model")},
                            {}),
    "yi/embed=model,data": ("yi-6b", (2, 2), {"embed": ("model", "data")},
                            {}),
    "yi/glu_half_unsplit": ("yi-6b", (2, 2),
                            {"embed": None, "mlp": ("data", "model")},
                            {"d_ff": 6}),
    "deepseek/q_straddles_kv_groups": ("deepseek-67b", (1, 3), None, {}),
    "yi/kv_heads_over_data": ("yi-6b", (2, 2),
                              {"batch": None, "kv_heads": "data"}, {}),
}
B, S, STEPS, CACHE_LEN = 4, 16, 2, 32
TRAIN_B, TRAIN_S, MB = 8, 16, 2
OPT = dict(lr=3e-4, warmup_steps=1, total_steps=10, eps=1e-2)
#: logits and the gathered cache, of max |logit| and of a leaf's max
TOL_SERVE = 1e-5
#: a gathered first moment, of its leaf's max; Griffin's RG-LRU decay
#: leaves (torch's expm1 on the CPU, tests/test_torch_training.py)
TOL_GRAD, TOL_EXPM1 = 1e-4, 1e-3
EXPM1_LEAVES = ("w_rec_gate", "b_rec_gate", "lambda_p")

_CONFIG = textwrap.dedent("""
    def config(get_config, arch, over, dtype, **kw):
        import dataclasses
        over = dict(over)
        cfg = get_config(arch, reduced=True).with_(
            dtype=dtype, kv_cache_dtype=dtype, **kw)
        if "d_ff_expert" in over:
            cfg = cfg.with_(moe=dataclasses.replace(
                cfg.moe, d_ff_expert=over.pop("d_ff_expert")))
        return cfg.with_(**over)
""")

_REFERENCE_PROG = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
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
    """) + _CONFIG + textwrap.dedent("""
    tmp = sys.argv[2]
    spec = json.load(open(os.path.join(tmp, "cases.json")))
    inp = dict(np.load(os.path.join(tmp, "inputs.npz")))
    out = {}
    tcfg = TrainConfig(optimizer=adamw.AdamWConfig(**spec["opt"]),
                       microbatches=spec["mb"], loss_chunk=8)
    for case, (arch, shape, rules, over) in spec["cases"].items():
        cfg = config(get_config, arch, over, jnp.float32)
        mod = family_module(cfg)
        like = jax.eval_shape(lambda k: mod.init(cfg, k),
                              jax.random.PRNGKey(0))
        n = len(jax.tree.leaves(like))

        def load():
            return jax.tree.unflatten(jax.tree.structure(like), [
                jnp.asarray(inp[f"{case}/param/{i:03d}"])
                for i in range(n)])

        mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:shape[0] * shape[1]])
        s = spec["s"]
        batch = {"tokens": jnp.asarray(inp[f"{case}/tokens"][:, :s])}
        if cfg.encdec is not None:
            batch["audio_embeds"] = jnp.asarray(inp[f"{case}/audio"])
        steps = jnp.asarray(inp[f"{case}/tokens"][:, s:])
        with logical.use_rules(mesh, rules):
            params = load()
            params = sharding.apply_shardings(
                params, sharding.param_shardings(params, mesh, rules))
            batch = sharding.apply_shardings(
                batch, sharding.batch_shardings(batch, mesh, rules))
            cache = mod.init_cache(cfg, spec["batch"], spec["cache_len"])
            cache = sharding.apply_shardings(
                cache, sharding.cache_shardings(cache, mesh, cfg, rules))
            prefill = jax.jit(lambda p, b, c: mod.prefill(cfg, p, b, c))
            decode = jax.jit(lambda p, t, c, i: mod.decode_step(cfg, p, t,
                                                                c, i))
            logits, cache = prefill(params, batch, cache)
            out[f"{case}/logits/0"] = np.asarray(logits)
            for i in range(spec["steps"]):
                logits, cache = decode(params, steps[:, i:i + 1], cache,
                                       jnp.int32(s + i))
                out[f"{case}/logits/{i + 1}"] = np.asarray(logits)
            for j, leaf in enumerate(jax.tree.leaves(cache)):
                out[f"{case}/cache/{j}"] = np.asarray(leaf)
            tb = {k: jnp.asarray(inp[f"{case}/train/{k}"])
                  for k in spec["train_keys"][case]}
            tb = sharding.apply_shardings(
                tb, sharding.batch_shardings(tb, mesh, rules))
            opt = adamw.init(tcfg.optimizer, params)
            _, o, m, _ = jax.jit(make_train_step(cfg.with_(remat="full"),
                                                 tcfg))(params, opt, tb)
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
    """) + _CONFIG + textwrap.dedent("""

    def rank_main(world, tmp):
        torch.set_num_threads(1)
        from repro_torch.configs.registry import get_config
        from repro_torch.core import tree
        from repro_torch.distributed import logical, sharding
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.base import family_module
        from repro_torch.optim import adamw
        from repro_torch.serving.engine import make_decode, make_prefill
        from repro_torch.training.train_step import (TrainConfig,
                                                     make_train_step)

        spec = json.load(open(os.path.join(tmp, "cases.json")))
        inp = {k: torch.from_numpy(v) for k, v in
               np.load(os.path.join(tmp, "inputs.npz")).items()}
        tcfg = TrainConfig(optimizer=adamw.AdamWConfig(**spec["opt"]),
                           microbatches=spec["mb"], loss_chunk=8)
        meshes, out = {}, {}
        s = spec["s"]
        for case, (arch, shape, rules, over) in spec["cases"].items():
            shape = tuple(shape)
            if shape not in meshes:          # every rank makes each mesh
                meshes[shape] = make_mesh(shape, ("data", "model"))
            mesh = meshes[shape]
            if not mesh.has_rank:
                continue
            cfg = config(get_config, arch, over, torch.float32)
            mod = family_module(cfg)
            like = mod.init(cfg, None, "meta")
            # copies: a leaf the rules keep whole is its own shard, and a
            # train step writes into it
            params = tree.unflatten(like, [
                inp[f"{case}/param/{i:03d}"].clone()
                for i in range(len(tree.leaves(like)))])
            local = sharding.shard_params(params, mesh, rules,
                                          glu=cfg.mlp_glu)
            cache = sharding.shard_cache(mod.init_cache(
                cfg, spec["batch"], spec["cache_len"]), mesh, cfg, rules)
            batch = {"tokens": inp[f"{case}/tokens"][:, :s]}
            if cfg.encdec is not None:
                batch["audio_embeds"] = inp[f"{case}/audio"]
            with logical.use_rules(mesh, rules):
                lb = sharding.local_batch(batch, mesh, 1, rules)
                steps = sharding.local_batch(
                    {"t": inp[f"{case}/tokens"][:, s:]}, mesh, 1,
                    rules)["t"]
                logits, cache = make_prefill(cfg)(local, lb, cache)
                out[f"{case}/logits/0"] = logits
                for i in range(spec["steps"]):
                    logits, cache = make_decode(cfg)(
                        local, steps[:, i:i + 1], cache, s + i)
                    out[f"{case}/logits/{i + 1}"] = logits
            whole = sharding.gather_cache(cache, mesh, cfg, rules)
            for j, leaf in enumerate(tree.leaves(whole)):
                out[f"{case}/cache/{j}"] = leaf
            n = len(lb["tokens"])              # the rank's rows' block
            out[f"{case}/rows"] = np.array([n, next(
                i for i in range(spec["batch"] // n) if torch.equal(
                    batch["tokens"][i * n:(i + 1) * n], lb["tokens"]))])
            opt = adamw.init(tcfg.optimizer, local)
            train_cfg = cfg.with_(remat="full", backend="torch")
            with logical.use_rules(mesh, rules):
                tb = sharding.local_batch(
                    {k: inp[f"{case}/train/{k}"]
                     for k in spec["train_keys"][case]},
                    mesh, spec["mb"], rules)
                _, o, m, _ = make_train_step(train_cfg, tcfg)(local, opt, tb)
                mu = sharding.gather_params(o["mu"], like, mesh, rules,
                                            glu=cfg.mlp_glu)
            out[f"{case}/loss"] = m["loss"]
            for i, x in enumerate(tree.leaves(mu)):
                out[f"{case}/mu/{i:03d}"] = x
        np.savez(os.path.join(tmp, f"rank{world.rank}.npz"),
                 **{k: np.asarray(v) for k, v in out.items()})


    if __name__ == "__main__":
        run_world(rank_main, 4, (sys.argv[2],), device="cpu",
                  rendezvous=os.path.join(sys.argv[2], "rendezvous"),
                  timeout=float(sys.argv[3]))
""")


def _j_config(arch, over):
    import jax.numpy as jnp
    ns = {}
    exec(_CONFIG, ns)
    return ns["config"](j_get_config, arch, over, jnp.float32)


def _inputs(tmp, cases):
    """Each case's reference params (fp32, reduced), seeded tokens,
    Whisper's audio embeddings and the train batch, the same for every
    case of one configuration."""
    inp, keys = {}, {}
    for case, (arch, _, _, over) in cases.items():
        cfg = _j_config(arch, over)
        params = j_family(cfg).init(cfg, jax.random.PRNGKey(3))
        for j, leaf in enumerate(jax.tree.leaves(params)):
            inp[f"{case}/param/{j:03d}"] = np.asarray(leaf)
        rng = np.random.default_rng(zlib.crc32(arch.encode()))
        inp[f"{case}/tokens"] = rng.integers(
            0, cfg.vocab_size, (B, S + STEPS)).astype(np.int32)
        toks = rng.integers(0, cfg.vocab_size,
                            (TRAIN_B, TRAIN_S + 1)).astype(np.int32)
        inp[f"{case}/train/tokens"] = toks[:, :-1]
        inp[f"{case}/train/labels"] = toks[:, 1:]
        keys[case] = ["tokens", "labels"]
        if cfg.encdec is not None:
            ctx = cfg.encdec.n_audio_ctx
            inp[f"{case}/audio"] = rng.standard_normal(
                (B, ctx, cfg.d_model)).astype(np.float32)
            inp[f"{case}/train/audio_embeds"] = rng.standard_normal(
                (TRAIN_B, ctx, cfg.d_model)).astype(np.float32)
            keys[case].append("audio_embeds")
    np.savez(os.path.join(tmp, "inputs.npz"), **inp)
    with open(os.path.join(tmp, "cases.json"), "w") as f:
        json.dump({"cases": cases, "batch": B, "s": S, "steps": STEPS,
                   "cache_len": CACHE_LEN, "opt": OPT, "mb": MB,
                   "train_keys": keys}, f)


def run_worlds(tmp, cases):
    """(the reference's results, each port rank's results) of ``cases``."""
    _inputs(tmp, cases)
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
             for r in range(4)]
    return ref, ranks


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return run_worlds(str(tmp_path_factory.mktemp("placement_forms")), CASES)


def _leaves(out, prefix):
    keys = sorted(k for k in out if k.startswith(prefix))
    return [out[k] for k in keys]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _ranks_of(ranks, case):
    """The ranks that ran ``case`` (a 3-rank mesh leaves one out)."""
    got = [out for out in ranks if f"{case}/loss" in out]
    assert got, case
    return got


def _rows(out, case):
    """The reference's rows that a rank's serving batch holds."""
    n, block = (int(v) for v in out[f"{case}/rows"])
    return slice(block * n, (block + 1) * n)


def check_logits(ref, ranks, case):
    """Each rank's prefill and decode logits (its rows) within
    ``TOL_SERVE`` of max |logit| of the reference's, greedy identical."""
    for out in _ranks_of(ranks, case):
        rows = _rows(out, case)
        for i in range(STEPS + 1):
            want = ref[f"{case}/logits/{i}"][rows]
            got = out[f"{case}/logits/{i}"]
            assert got.shape == want.shape
            assert _rel(got, want) <= TOL_SERVE, i
            np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def check_cache(ref, ranks, case):
    """The cache gathered from every rank's shards after the prefill and
    the decode steps, within ``TOL_SERVE`` of its max, leaf by leaf."""
    want = _leaves(ref, f"{case}/cache/")
    for out in _ranks_of(ranks, case):
        got = _leaves(out, f"{case}/cache/")
        assert len(got) == len(want) > 0
        for j, (a, b) in enumerate(zip(got, want)):
            assert a.shape == b.shape, j
            assert _rel(a, b) <= TOL_SERVE, j


def check_step(ref, ranks, case, names):
    """Every rank's loss within 1e-5 relative and each gathered first
    moment within ``TOL_GRAD`` of its max (``TOL_EXPM1`` for the leaves
    ``names`` marks as Griffin's decay leaves)."""
    loss = float(ref[f"{case}/loss"])
    want = _leaves(ref, f"{case}/mu/")
    for out in _ranks_of(ranks, case):
        assert abs(float(out[f"{case}/loss"]) - loss) <= 1e-5 * abs(loss)
        got = _leaves(out, f"{case}/mu/")
        assert len(got) == len(want) > 0
        for i, (a, b) in enumerate(zip(got, want)):
            tol = TOL_EXPM1 if names[i] in EXPM1_LEAVES else TOL_GRAD
            assert _rel(a, b) <= tol, (i, names[i])


def leaf_names(case, cases):
    """The last path component of each param leaf of ``case``'s model."""
    from repro_torch.core import tree
    from repro_torch.models.base import family_module
    arch, _, _, over = cases[case]
    ns = {}
    exec(_CONFIG, ns)
    from repro_torch.configs.registry import get_config
    cfg = ns["config"](get_config, arch, over, torch.float32)
    like = family_module(cfg).init(cfg, None, "meta")
    return [next((p for p in reversed(path) if isinstance(p, str)), "")
            for path, _ in tree.flatten_with_path(like)]


@pytest.mark.parametrize("case", list(CASES))
def test_logits_match_reference_meshed(worlds, case):
    check_logits(*worlds, case)


@pytest.mark.parametrize("case", list(CASES))
def test_cache_matches_reference(worlds, case):
    check_cache(*worlds, case)


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_reference_meshed(worlds, case):
    check_step(*worlds, case, leaf_names(case, CASES))
