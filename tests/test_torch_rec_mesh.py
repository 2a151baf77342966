"""The recurrent families and Whisper on a mesh: RecurrentGemma (Griffin),
RWKV-6 and Whisper served and trained on a rank's shards, against the
reference's meshed steps.

The reference places every leaf by its name rules (``param_shardings``,
``cache_shardings``) and lets GSPMD move the data.  The port's rank holds
its shards: Griffin's recurrent block on its share of the d_rnn channels
(K5 on them), its local attention's ring in the reference's sequence
form (or whole where ``model`` does not divide the window); RWKV-6's
time mix on its heads (K6 on them, with its heads' share of the state)
and its channel mix column- then row-parallel; Whisper's attentions on
its heads (every head where they do not divide ``model``), its GELU MLP
column- then row-parallel, and its self and cross caches in the KV-head,
sequence or whole form.  The recurrent state stays in the reference's
form, whole over ``model``; the unstacked tail of Griffin's stack keeps
its carry split along the channels over the data axes, as the
reference's ``cache_shardings`` splits a (B, C) leaf's second dim.

The multi-rank cases run in two subprocesses on the same numpy inputs,
as ``tests/test_torch_seq_cache.py`` runs its own: the reference on 8
forced host devices, each case jitted under ``logical.use_rules`` of a
mesh over the first devices, its params, batch and cache placed by the
reference's shardings, on its ``xla`` route (its Pallas RG-LRU does not
run on this JAX); the port in a gloo world of 8 CPU ranks
(``launch.mesh.run_world``), each rank serving through
``serving.engine.make_prefill`` / ``make_decode`` and training through
``training.train_step.make_train_step``.  Reduced configurations in
fp32.  Serving: 4 prompts, 2 decode steps; logits within 1e-5 of max
|logit|, greedy tokens identical, the gathered cache and state within
TOL_CACHE of its max and zero where the reference's is.  Training: one
AdamW step (2 microbatches of 4 x 16 tokens, eps 1e-2 as in
``tests/test_torch_tensor_parallel.py``): the loss within 1e-5 relative
and every gathered leaf (parameters and first moment) within 1e-5 of its
max (``TOL_STEP``: RWKV-6's step, whose rounding the reference's own
meshed step moves by more, at 1e-4), against the reference's step on one
device and, on (2, 2), meshed, and against the port's step on one rank.
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
from repro_torch import NotPorted                         # noqa: E402
from repro_torch.configs import registry as reg           # noqa: E402
from repro_torch.distributed import logical, sharding     # noqa: E402
from repro_torch.launch.mesh import rank_view             # noqa: E402
from repro_torch.models.base import family_module         # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
WORLD_TIMEOUT = 300          # seconds, each subprocess
B, STEPS = 4, 2
TRAIN_B, TRAIN_S, MB = 8, 16, 2
OPT = dict(lr=3e-4, warmup_steps=1, total_steps=10, eps=1e-2)
#: the gathered cache's and state's limit, of a leaf's max
TOL_CACHE = 1e-5
ARCHS = ("recurrentgemma-2b", "rwkv6-7b", "whisper-tiny")
#: config variants: overrides of the reduced configs (a window the model
#: axis of 4 does not divide; an audio context the axis of 8 does not)
VARIANTS = {"base": {}, "win10": {"window": 10}, "ctx20": {"n_audio_ctx": 20}}
#: serving case -> (arch, (data, model), cache length, prompt, variant).
#: Griffin's window of 16: 8, 4 and 2 slots a rank on 2, 4 and 8 (the
#: sequence form), whole on 4 with a window of 10; prompts of 23 wrap
#: it; a data axis of 2 splits its tail's carry along the channels.
#: Whisper's 4 heads: the KV-head form on 2 and 4; on 8 every head a
#: rank, the self cache (32) and the cross cache (24) in the sequence
#: form, or whole at 30 and 20.
CASES = {
    "griffin/2x2": ("recurrentgemma-2b", (2, 2), 32, 12, "base"),
    "griffin/1x4": ("recurrentgemma-2b", (1, 4), 32, 12, "base"),
    "griffin/1x8/wrap": ("recurrentgemma-2b", (1, 8), 32, 23, "base"),
    "griffin/2x4/whole/wrap": ("recurrentgemma-2b", (2, 4), 32, 23,
                               "win10"),
    "rwkv/2x2": ("rwkv6-7b", (2, 2), 32, 12, "base"),
    "rwkv/1x4": ("rwkv6-7b", (1, 4), 32, 12, "base"),
    "rwkv/2x4": ("rwkv6-7b", (2, 4), 32, 12, "base"),
    "whisper/2x2": ("whisper-tiny", (2, 2), 32, 12, "base"),
    "whisper/1x4": ("whisper-tiny", (1, 4), 32, 12, "base"),
    "whisper/1x8/seq": ("whisper-tiny", (1, 8), 32, 12, "base"),
    "whisper/1x8/whole": ("whisper-tiny", (1, 8), 30, 12, "ctx20"),
}
#: training case -> (arch, (data, model))
TRAIN = {
    "griffin/2x2": ("recurrentgemma-2b", (2, 2)),
    "griffin/1x4": ("recurrentgemma-2b", (1, 4)),
    "griffin/1x8": ("recurrentgemma-2b", (1, 8)),
    "rwkv/2x2": ("rwkv6-7b", (2, 2)),
    "rwkv/1x4": ("rwkv6-7b", (1, 4)),
    "whisper/2x2": ("whisper-tiny", (2, 2)),
    "whisper/1x4": ("whisper-tiny", (1, 4)),
    "whisper/1x8": ("whisper-tiny", (1, 8)),
}
TRAIN_REF_MESHED = ("griffin/2x2", "rwkv/2x2", "whisper/2x2")
#: a trained leaf's limit, of its max.  RWKV-6's step amplifies fp32
#: rounding: on these cases the reference's own meshed step lies 2.1e-5
#: from its one-device step (the first moment's max over leaves), the
#: port's one-rank step 3.7e-5 from it, and the port's meshed steps
#: 4.0e-5 from it and 1.7e-5 from the port's one-rank step; it is held
#: as ``tests/test_torch_training.py`` holds every family's step on one
#: rank, at 1e-4.  Griffin's RG-LRU decay leaves differ from the
#: reference's by torch's expm1 on the CPU (``tests/test_torch_training.
#: py``'s EXPM1_LEAVES, measured here 3.3e-4 of their max, whose max is
#: 1e-9 to 1e-7) and are held there at its 1e-3 against the reference;
#: against the port's one-rank step every Griffin leaf holds 1e-5
TOL_STEP = {"rwkv6-7b": 1e-4}
EXPM1_LEAVES, TOL_EXPM1_LEAVES = ("w_rec_gate", "b_rec_gate",
                                  "lambda_p"), 1e-3

_CONFIG = textwrap.dedent("""
    def config(get_config, arch, variant, dtype, spec, **kw):
        import dataclasses
        over = dict(spec["variants"][variant])
        cfg = get_config(arch, reduced=True).with_(
            dtype=dtype, kv_cache_dtype=dtype, **kw)
        if "n_audio_ctx" in over:
            cfg = cfg.with_(encdec=dataclasses.replace(
                cfg.encdec, n_audio_ctx=over.pop("n_audio_ctx")))
        return cfg.with_(**over)
""")

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
    """) + _CONFIG + textwrap.dedent("""
    tmp = sys.argv[2]
    spec = json.load(open(os.path.join(tmp, "cases.json")))
    inp = dict(np.load(os.path.join(tmp, "inputs.npz")))
    out = {}

    def load(cfg, key):
        mod = family_module(cfg)
        like = jax.eval_shape(lambda k: mod.init(cfg, k),
                              jax.random.PRNGKey(0))
        n = len(jax.tree.leaves(like))
        return mod, jax.tree.unflatten(jax.tree.structure(like), [
            jnp.asarray(inp[f"{key}/param/{i:03d}"]) for i in range(n)])

    def mesh_of(shape):
        return jax.make_mesh(tuple(shape), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:shape[0] * shape[1]])

    for case, (arch, shape, cache_len, s, variant) in spec["cases"].items():
        cfg = config(get_config, arch, variant, jnp.float32, spec)
        mod, params = load(cfg, f"{arch}/{variant}")
        batch = {"tokens": jnp.asarray(inp[f"{arch}/tokens"][:, :s])}
        if cfg.encdec is not None:
            batch["audio_embeds"] = jnp.asarray(
                inp[f"{arch}/{variant}/audio"])
        steps = jnp.asarray(inp[f"{arch}/tokens"][:, s:s + spec["steps"]])
        mesh = mesh_of(shape)
        with logical.use_rules(mesh):
            cache = mod.init_cache(cfg, spec["batch"], cache_len)
            params = sharding.apply_shardings(
                params, sharding.param_shardings(params, mesh))
            batch = sharding.apply_shardings(
                batch, sharding.batch_shardings(batch, mesh))
            cache = sharding.apply_shardings(
                cache, sharding.cache_shardings(cache, mesh, cfg))
            for j, leaf in enumerate(jax.tree.leaves(cache)):
                out[f"{case}/held/{j}"] = np.array(
                    leaf.addressable_shards[0].data.shape)
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

    tcfg = TrainConfig(optimizer=adamw.AdamWConfig(**spec["opt"]),
                       microbatches=spec["mb"], loss_chunk=8)

    def train_setup(arch):
        cfg = config(get_config, arch, "base", jnp.float32, spec,
                     remat="full")
        mod, params = load(cfg, f"{arch}/base")
        batch = {k: jnp.asarray(inp[f"{arch}/train/{k}"])
                 for k in spec["train_keys"][arch]}
        return cfg, params, batch

    def record(tag, p, o, m):
        out[f"{tag}/loss"] = np.asarray(m["loss"])
        for i, x in enumerate(jax.tree.leaves(p)):
            out[f"{tag}/param/{i:03d}"] = np.asarray(x)
        for i, x in enumerate(jax.tree.leaves(o["mu"])):
            out[f"{tag}/mu/{i:03d}"] = np.asarray(x)

    for arch in spec["archs"]:
        cfg, params, batch = train_setup(arch)
        p, o, m, _ = jax.jit(make_train_step(cfg, tcfg))(
            params, adamw.init(tcfg.optimizer, params), batch)
        record(f"{arch}/one", p, o, m)
    for case in spec["train_ref_meshed"]:
        arch, shape = spec["train"][case]
        cfg, params, batch = train_setup(arch)
        mesh = mesh_of(shape)
        with logical.use_rules(mesh):
            params = sharding.apply_shardings(
                params, sharding.param_shardings(params, mesh))
            batch = sharding.apply_shardings(
                batch, sharding.batch_shardings(batch, mesh))
            opt = adamw.init(tcfg.optimizer, params)
            p, o, m, _ = jax.jit(make_train_step(cfg, tcfg))(params, opt,
                                                             batch)
            record(f"{case}/mesh", p, o, m)
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
        meshes = {}
        out = {}

        def mesh_of(shape):
            shape = tuple(shape)
            if shape not in meshes:          # every rank makes each mesh
                meshes[shape] = make_mesh(shape, ("data", "model"))
            return meshes[shape]

        def load(cfg, key):
            like = family_module(cfg).init(cfg, None, "meta")
            # copies: a leaf the rules keep whole is its own shard, and a
            # train step writes into it
            return tree.unflatten(like, [
                inp[f"{key}/param/{i:03d}"].clone()
                for i in range(len(tree.leaves(like)))])

        for case, (arch, shape, cache_len, s, variant) in \\
                spec["cases"].items():
            mesh = mesh_of(shape)
            if not mesh.has_rank:
                continue
            cfg = config(get_config, arch, variant, torch.float32, spec)
            mod = family_module(cfg)
            params = load(cfg, f"{arch}/{variant}")
            batch = {"tokens": inp[f"{arch}/tokens"][:, :s]}
            if cfg.encdec is not None:
                batch["audio_embeds"] = inp[f"{arch}/{variant}/audio"]
            steps = inp[f"{arch}/tokens"][:, s:s + spec["steps"]]
            local = sharding.shard_params(params, mesh, glu=cfg.mlp_glu)
            cache = sharding.shard_cache(
                mod.init_cache(cfg, spec["batch"], cache_len), mesh, cfg)
            for j, leaf in enumerate(tree.leaves(cache)):
                out[f"{case}/held/{j}"] = np.array(leaf.shape)
            with logical.use_rules(mesh):
                lb = sharding.local_batch(batch, mesh)
                rows = sharding.local_batch({"t": steps}, mesh)["t"]
                logits, cache = make_prefill(cfg)(local, lb, cache)
                out[f"{case}/logits/0"] = logits
                for i in range(spec["steps"]):
                    logits, cache = make_decode(cfg)(
                        local, rows[:, i:i + 1], cache, s + i)
                    out[f"{case}/logits/{i + 1}"] = logits
            whole = sharding.gather_cache(cache, mesh, cfg)
            for j, leaf in enumerate(tree.leaves(whole)):
                out[f"{case}/cache/{j}"] = leaf
            out[f"{case}/data"] = np.array(mesh.index("data"))

        tcfg = TrainConfig(optimizer=adamw.AdamWConfig(**spec["opt"]),
                           microbatches=spec["mb"], loss_chunk=8)

        def record(tag, p, mu, m):
            out[f"{tag}/loss"] = m["loss"]
            for i, x in enumerate(tree.leaves(p)):
                out[f"{tag}/param/{i:03d}"] = x
            for i, x in enumerate(tree.leaves(mu)):
                out[f"{tag}/mu/{i:03d}"] = x

        def train_setup(arch):
            cfg = config(get_config, arch, "base", torch.float32, spec,
                         remat="full", backend="torch")
            batch = {k: inp[f"{arch}/train/{k}"]
                     for k in spec["train_keys"][arch]}
            return cfg, load(cfg, f"{arch}/base"), batch

        for case, (arch, shape) in spec["train"].items():
            mesh = mesh_of(shape)
            if not mesh.has_rank:
                continue
            cfg, params, batch = train_setup(arch)
            local = sharding.shard_params(params, mesh, glu=cfg.mlp_glu)
            if case == "whisper/1x4":
                back = sharding.gather_params(local, params, mesh,
                                              glu=cfg.mlp_glu)
                out["wi/roundtrip"] = np.array(all(
                    torch.equal(a, b) for a, b in
                    zip(tree.leaves(back), tree.leaves(params))))
                out["wi/local"] = local["dec_layers"]["mlp"]["wi"][0].clone()
            opt = adamw.init(tcfg.optimizer, local)
            with logical.use_rules(mesh):
                lb = sharding.local_batch(batch, mesh, spec["mb"])
                p, o, m, _ = make_train_step(cfg, tcfg)(local, opt, lb)
                p = sharding.gather_params(p, params, mesh, glu=cfg.mlp_glu)
                mu = sharding.gather_params(o["mu"], params, mesh,
                                            glu=cfg.mlp_glu)
            record(case, p, mu, m)
        if world.rank == 0:                  # the port's step on one rank
            for arch in spec["archs"]:
                cfg, params, batch = train_setup(arch)
                p, o, m, _ = make_train_step(cfg, tcfg)(
                    params, adamw.init(tcfg.optimizer, params), batch)
                record(f"{arch}/one", p, o["mu"], m)
        np.savez(os.path.join(tmp, f"rank{world.rank}.npz"),
                 **{k: np.asarray(v) for k, v in out.items()})


    if __name__ == "__main__":
        run_world(rank_main, 8, (sys.argv[2],), device="cpu",
                  rendezvous=os.path.join(sys.argv[2], "rendezvous"),
                  timeout=float(sys.argv[3]))
""")


def _j_config(arch, variant, **kw):
    ns = {}
    exec(_CONFIG, ns)
    return ns["config"](j_get_config, arch, variant, jnp.float32,
                        {"variants": VARIANTS}, **kw)


def _inputs(tmp):
    """The reference's reduced params (fp32) of each arch and variant,
    seeded tokens, Whisper's audio embeddings and the train batches."""
    inp, keys = {}, {}
    for i, arch in enumerate(ARCHS):
        variants = {"base"} | {c[4] for c in CASES.values() if c[0] == arch}
        rng = np.random.default_rng(20 + i)
        for variant in sorted(variants):
            cfg = _j_config(arch, variant)
            params = j_family(cfg).init(cfg, jax.random.PRNGKey(3))
            for j, leaf in enumerate(jax.tree.leaves(params)):
                inp[f"{arch}/{variant}/param/{j:03d}"] = np.asarray(leaf)
            if cfg.encdec is not None:
                inp[f"{arch}/{variant}/audio"] = rng.standard_normal(
                    (B, cfg.encdec.n_audio_ctx, cfg.d_model)).astype(
                        np.float32)
        cfg = _j_config(arch, "base")
        inp[f"{arch}/tokens"] = rng.integers(
            0, cfg.vocab_size, (B, 32)).astype(np.int32)
        toks = rng.integers(0, cfg.vocab_size,
                            (TRAIN_B, TRAIN_S + 1)).astype(np.int32)
        inp[f"{arch}/train/tokens"] = toks[:, :-1]
        inp[f"{arch}/train/labels"] = toks[:, 1:]
        keys[arch] = ["tokens", "labels"]
        if cfg.encdec is not None:
            inp[f"{arch}/train/audio_embeds"] = rng.standard_normal(
                (TRAIN_B, cfg.encdec.n_audio_ctx, cfg.d_model)).astype(
                    np.float32)
            keys[arch].append("audio_embeds")
    np.savez(os.path.join(tmp, "inputs.npz"), **inp)
    with open(os.path.join(tmp, "cases.json"), "w") as f:
        json.dump({"cases": CASES, "variants": VARIANTS, "batch": B,
                   "steps": STEPS, "archs": ARCHS, "train": TRAIN,
                   "train_ref_meshed": TRAIN_REF_MESHED, "opt": OPT,
                   "mb": MB, "train_keys": keys}, f)
    return inp


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """(inputs, the reference's results, each port rank's results)."""
    tmp = str(tmp_path_factory.mktemp("rec_mesh_worlds"))
    inp = _inputs(tmp)
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
    return inp, ref, ranks


def _ranks_of(ranks, shape):
    return ranks[:shape[0] * shape[1]]


def _leaves(out, tag, kind):
    keys = sorted(k for k in out if k.startswith(f"{tag}/{kind}/"))
    return [out[k] for k in keys]


def _leaf_rels(ours, ref):
    """Each leaf's largest distance from the reference's, over its max."""
    assert len(ours) == len(ref) > 0
    out = []
    for o, r in zip(ours, ref):
        assert o.shape == r.shape
        o, r = o.astype(np.float64), r.astype(np.float64)
        out.append(np.abs(o - r).max() / max(np.abs(r).max(), 1e-30))
    return out


def _limits(arch, against_reference):
    """Each leaf's limit (``TOL_STEP``, ``EXPM1_LEAVES``), in tree order."""
    from repro_torch.core import tree
    cfg = reg.get_config(arch, reduced=True)
    like = family_module(cfg).init(cfg, None, "meta")
    tol = TOL_STEP.get(arch, 1e-5)
    return [TOL_EXPM1_LEAVES if against_reference and path[-1] in
            EXPM1_LEAVES else tol for path, _ in tree.flatten_with_path(like)]


def _step_holds(out, case, ref, tag, arch, against_reference):
    loss = float(ref[f"{tag}/loss"])
    assert abs(float(out[f"{case}/loss"]) - loss) <= 1e-5 * abs(loss)
    limits = _limits(arch, against_reference)
    for kind in ("param", "mu"):
        rels = _leaf_rels(_leaves(out, case, kind), _leaves(ref, tag, kind))
        assert all(r <= t for r, t in zip(rels, limits)), max(
            zip(rels, limits), key=lambda x: x[0] / x[1])


class TestServedOnAMesh:
    @pytest.mark.parametrize("case", list(CASES))
    def test_logits_match_reference_meshed(self, worlds, case):
        """Each rank's prefill and decode logits (its batch rows) within
        1e-5 of max |logit| of the reference's meshed ones, the greedy
        tokens identical."""
        _, ref, ranks = worlds
        shape = CASES[case][1]
        for out in _ranks_of(ranks, shape):
            data = int(out[f"{case}/data"])
            n = B // shape[0]
            for i in range(STEPS + 1):
                want = ref[f"{case}/logits/{i}"][data * n:(data + 1) * n]
                got = out[f"{case}/logits/{i}"]
                assert got.shape == want.shape
                assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
                np.testing.assert_array_equal(got.argmax(-1),
                                              want.argmax(-1))

    @pytest.mark.parametrize("case", list(CASES))
    def test_gathered_cache_matches_reference(self, worlds, case):
        """The cache and state gathered from every rank's shard
        (``gather_cache``) after the prefill and decode steps: zero where
        the reference's is and within TOL_CACHE of its max elsewhere;
        rank 0 held the shard the reference's rank 0 holds, leaf by leaf
        (Griffin's ring a share of the window or all of it, its tail's
        carry a share of the channels on a data axis of 2, RWKV-6's state
        the rank's heads, Whisper's caches each in its form)."""
        _, ref, ranks = worlds
        j = 0
        while f"{case}/cache/{j}" in ref:
            np.testing.assert_array_equal(ranks[0][f"{case}/held/{j}"],
                                          ref[f"{case}/held/{j}"])
            want = ref[f"{case}/cache/{j}"]
            for out in _ranks_of(ranks, CASES[case][1]):
                got = out[f"{case}/cache/{j}"]
                assert got.shape == want.shape
                np.testing.assert_array_equal(got == 0, want == 0)
                assert np.abs(got - want).max() <= TOL_CACHE * max(
                    np.abs(want).max(), 1e-30)
            j += 1
        assert j > 0 and f"{case}/cache/{j}" not in ranks[0]

    def test_forms_the_cases_cover(self, worlds):
        """The cases reach each form: Griffin's ring split along the
        window and whole, its tail's carry split along the channels;
        Whisper's caches by KV heads, by positions and whole."""
        _, ref, _ = worlds
        held = {case: [ref[f"{case}/held/{j}"] for j in range(
            sum(1 for k in ref if k.startswith(f"{case}/held/")))]
            for case in CASES}
        # Griffin's leaves in tree order (sorted keys): the tail's conv
        # and h twice, then the triples' conv and h twice, k and v
        ring = {c: tuple(held[c][8][3:4]) for c in CASES if "griffin" in c}
        assert ring == {"griffin/2x2": (8,), "griffin/1x4": (4,),
                        "griffin/1x8/wrap": (2,),
                        "griffin/2x4/whole/wrap": (10,)}
        assert tuple(held["griffin/2x2"][1]) == (B, 32)
        heads = {c: int(held[c][0][2]) for c in CASES if "whisper" in c}
        assert heads == {"whisper/2x2": 2, "whisper/1x4": 1,
                         "whisper/1x8/seq": 4, "whisper/1x8/whole": 4}
        assert [int(x[3]) for x in held["whisper/1x8/seq"]] == [3, 3, 4, 4]
        assert [int(x[3]) for x in held["whisper/1x8/whole"]] == [
            20, 20, 30, 30]


class TestTrainedOnAMesh:
    @pytest.mark.parametrize("case", list(TRAIN))
    def test_step_matches_reference_on_one_device(self, worlds, case):
        """Every rank's step, gathered, against the reference's step on
        one device: the loss and each updated parameter and first
        moment."""
        _, ref, ranks = worlds
        arch, shape = TRAIN[case]
        for out in _ranks_of(ranks, shape):
            _step_holds(out, case, ref, f"{arch}/one", arch, True)

    @pytest.mark.parametrize("case", TRAIN_REF_MESHED)
    def test_step_matches_reference_meshed(self, worlds, case):
        """Against the reference's step jitted under the same mesh, its
        leaves placed by ``param_shardings``."""
        _, ref, ranks = worlds
        arch, shape = TRAIN[case]
        for out in _ranks_of(ranks, shape):
            _step_holds(out, case, ref, f"{case}/mesh", arch, True)

    @pytest.mark.parametrize("case", list(TRAIN))
    def test_step_matches_the_ports_one_rank_step(self, worlds, case):
        """Against the port's own step on one rank, the same arithmetic
        but for the sums the ranks split."""
        _, _, ranks = worlds
        arch, shape = TRAIN[case]
        for out in _ranks_of(ranks, shape):
            _step_holds(out, case, ranks[0], f"{arch}/one", arch, False)

    def test_plain_mlp_shards_are_contiguous_and_gather_back(self, worlds):
        """Whisper's GELU ``wi`` (not a GLU) takes the reference's
        contiguous column shard, and gathering every rank's shards gives
        the tree back bit for bit."""
        inp, _, ranks = worlds
        cfg = reg.get_config("whisper-tiny", reduced=True)
        from repro_torch.core import tree
        like = family_module(cfg).init(cfg, None, "meta")
        paths = [tree.path_str(p) for p, _ in tree.flatten_with_path(like)]
        wi = inp["whisper-tiny/base/param/"
                 f"{paths.index('dec_layers/mlp/wi'):03d}"][0]
        cols = cfg.d_ff // 4
        for r, out in enumerate(ranks[:4]):
            assert bool(out["wi/roundtrip"])
            np.testing.assert_array_equal(out["wi/local"],
                                          wi[:, r * cols:(r + 1) * cols])


# ---------------------------------------------------------------------------
# In process: shards on rank views, refusals.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("glu", [True, False])
def test_wi_pairs_its_halves_only_for_a_glu(glu):
    """On rank views of (data 2, model 2), no world: ``shard_params``
    pairs ``wi``'s gate and up halves where told the MLP is a GLU, and
    otherwise takes the contiguous columns, as the reference does."""
    d, ff = 8, 12
    wi = torch.arange(d * 2 * ff, dtype=torch.float32).reshape(d, 2 * ff)
    for r in range(4):
        view = rank_view((2, 2), ("data", "model"), divmod(r, 2))
        got = sharding.shard_params({"mlp": {"wi": wi}}, view,
                                    glu=glu)["mlp"]["wi"]
        data, model = divmod(r, 2)
        rows = slice(data * 4, data * 4 + 4)
        want = (torch.cat([wi[rows, model * 6:model * 6 + 6],
                           wi[rows, ff + model * 6:ff + model * 6 + 6]], 1)
                if glu else wi[rows, model * 12:model * 12 + 12])
        assert torch.equal(got, want)


def test_rwkv6_heads_that_do_not_divide_the_model_axis_name_7c():
    """RWKV-6's 4 reduced heads on a model axis of 8: its projections'
    columns would split a head and its state's key channels (the form
    the reference's ``cache_shardings`` then takes): the forward and the
    prefill raise ``NotPorted`` naming ROADMAP item 7c."""
    cfg = reg.get_config("rwkv6-7b", reduced=True).with_(dtype=torch.float32)
    mod = family_module(cfg)
    view = rank_view((1, 8), ("data", "model"))
    tokens = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    with logical.use_rules(view):
        params = sharding.shard_params(mod.init(cfg, None, "meta"), view,
                                       glu=cfg.mlp_glu)
        cache = sharding.shard_cache(
            mod.init_cache(cfg, 2, 8, device="meta"), view, cfg)
        assert cache["wkv"].shape[2:] == (cfg.n_heads, 32 // 8, 32)
        with pytest.raises(NotPorted, match="item 7c"):
            mod.forward(cfg, params, {"tokens": tokens})
        with pytest.raises(NotPorted, match="item 7c"):
            mod.prefill(cfg, params, {"tokens": tokens}, cache)


def test_a_state_leaf_without_its_whole_shape_is_refused():
    """A recurrent state leaf rebuilt from its shape alone is ambiguous
    on a data axis larger than 1 (its rows, or an unstacked leaf's
    channels, may be split): ``cache_placement`` asks for
    ``shard_cache``'s record, and reads the shape where nothing splits."""
    cfg = reg.get_config("recurrentgemma-2b", reduced=True)
    bare = torch.zeros((4, 64))
    with logical.use_rules(rank_view((2, 2), ("data", "model"))):
        with pytest.raises(ValueError, match="shard_cache"):
            sharding.cache_placement(bare, cfg, logical.active_mesh())
    with logical.use_rules(rank_view((1, 4), ("data", "model"))):
        assert sharding.cache_placement(bare, cfg, logical.active_mesh())[
            0] == (4, 64)
