"""Sequence parallelism for every family: the reference's ``{"seq":
"model"}`` rules on RecurrentGemma (Griffin), RWKV-6, Whisper, OLMoE in
both expert-parallel forms, internvl2 with its vision prefix and yi-6b
with a cache of every KV head, served and trained against the
reference's meshed steps under the same mesh and rules.

The reference lets GSPMD place the activations; the port's schedule is
Megatron sequence parallelism (``distributed.tensor_parallel``): between
blocks the residual stream holds the rank's share of the sequence, a
block's entry gathers it and its row-parallel exit reduce-scatters it.
Griffin's conv and RWKV-6's token shifts read across the shares, so
their blocks take the gathered stream; Whisper's frames and tokens are
two streams, each sharded where ``model`` divides its length (the
frames whole on 8 ranks at 20 frames); Griffin's prefill decides its
second pass over the window's tail by its own length; MoE routes the
gathered sequence at the whole sequence's capacity (a capacity factor
of 0.5, so that tokens overflow).  Where the rules keep a leaf whole
(the attention's and the MLP's, or the vocabulary's) the rank applies
it to its rows, or every rank computes every row over the gathered
stream and keeps its own: those cases run ``forward`` too (the
logits of a whole output weight) and a train step (its chunked loss);
Griffin's recurrent blocks, RWKV-6's mixes and OLMoE's experts held
whole train so too, and OLMoE's experts whole, or split over ``data``
alone, serve so.

As in ``tests/test_torch_rec_mesh.py``, two subprocesses on the same
numpy inputs (serving here, training in
``tests/test_torch_seq_parallel_train.py``, each a world of its own,
so that the two run side by side): the reference on 8 forced host
devices, each case jitted
under ``logical.use_rules(mesh, rules)`` with its params, batch and
cache placed by the reference's shardings under those rules (its
``xla`` route: its Pallas RG-LRU does not run on this JAX); the port in
a gloo world of 8 CPU ranks (``launch.mesh.run_world``), each rank
serving through ``serving.engine.make_prefill`` / ``make_decode`` and
training through ``training.train_step.make_train_step``.  Reduced
configurations in fp32.  Serving: 4 prompts, a prefill and 2 decode
steps; logits within 1e-5 of max |logit|, greedy tokens identical, the
gathered cache and state within 1e-5 of its max and zero where the
reference's is.

In process: ``launch.dryrun.run_cell`` under ``{"seq": "model"}`` on the
256-rank pod mesh counts each family's train and prefill cells.
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
from repro_torch.configs import registry as reg           # noqa: E402
from repro_torch.launch import dryrun                     # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
WORLD_TIMEOUT = 300          # seconds, each subprocess
B, STEPS = 4, 2
TRAIN_B, TRAIN_S, MB = 8, 16, 2
OPT = dict(lr=3e-4, warmup_steps=1, total_steps=10, eps=1e-2)
TOL, TOL_CACHE = 1e-5, 1e-5
SEQ = {"seq": "model"}
#: rules -> the rules a case runs under: sequence parallelism alone;
#: with perf_iter's ar_gspmd_ep placement of the experts; with the
#: attention's and the MLP's leaves whole ("heads" names the MLP's wo
#: too); with the vocabulary's leaves whole (embedding, output weight);
#: with the experts whole; with GSPMD's experts split over data alone
RULES = {"seq": SEQ,
         "gspmd": {"experts": "data", "mlp_expert": "model", "embed": None,
                   **SEQ},
         "attn_whole": {"heads": None, "kv_heads": None, "mlp": None, **SEQ},
         "vocab_whole": {"vocab": None, **SEQ},
         "experts_whole": {"experts": None, **SEQ},
         "gspmd_data": {"experts": "data", "mlp_expert": None,
                        "embed": None, **SEQ}}
#: config variants: overrides of the reduced configs
VARIANTS = {"base": {}, "ctx20": {"n_audio_ctx": 20},
            "cap05": {"capacity_factor": 0.5},
            "gspmd": {"capacity_factor": 0.5, "moe_shard_map": False}}
#: serving case -> (arch, (data, model), cache length, prompt, variant,
#: rules).  Griffin's prompts of 24 wrap its window of 16, whose tail
#: pass of 16 is sharded too; Whisper's 24 frames are sharded on 4 and
#: its 20 whole on 8, its prompts sharded on both; yi-6b's 2 KV heads on
#: 4 give a cache of every KV head at a share of the positions
CASES = {
    "griffin/1x4/wrap": ("recurrentgemma-2b", (1, 4), 32, 24, "base", "seq"),
    "griffin/1x8/wrap": ("recurrentgemma-2b", (1, 8), 32, 24, "base", "seq"),
    "rwkv/2x2": ("rwkv6-7b", (2, 2), 32, 12, "base", "seq"),
    "rwkv/1x4": ("rwkv6-7b", (1, 4), 32, 12, "base", "seq"),
    "whisper/1x4": ("whisper-tiny", (1, 4), 32, 12, "base", "seq"),
    "whisper/1x8/frames_whole": ("whisper-tiny", (1, 8), 32, 16, "ctx20",
                                 "seq"),
    "olmoe/1x4": ("olmoe-1b-7b", (1, 4), 32, 12, "cap05", "seq"),
    "olmoe/gspmd/2x2": ("olmoe-1b-7b", (2, 2), 32, 12, "gspmd", "gspmd"),
    "internvl/1x4": ("internvl2-1b", (1, 4), 32, 12, "base", "seq"),
    "yi/every_kv/1x4": ("yi-6b", (1, 4), 32, 12, "base", "seq"),
    "yi/attn_whole/1x4": ("yi-6b", (1, 4), 32, 12, "base", "attn_whole"),
    "yi/vocab_whole/1x4": ("yi-6b", (1, 4), 32, 12, "base", "vocab_whole"),
    "olmoe/experts_whole/1x4": ("olmoe-1b-7b", (1, 4), 32, 12, "cap05",
                                "experts_whole"),
    "olmoe/gspmd_data/2x2": ("olmoe-1b-7b", (2, 2), 32, 12, "gspmd",
                             "gspmd_data"),
}
#: the serving cases that also run ``forward`` over the prompt
FORWARD = ("yi/attn_whole/1x4", "yi/vocab_whole/1x4")
_CONFIG = textwrap.dedent("""
    def config(get_config, arch, variant, dtype, spec, **kw):
        import dataclasses
        over = dict(spec["variants"][variant])
        cfg = get_config(arch, reduced=True).with_(
            dtype=dtype, kv_cache_dtype=dtype, **kw)
        if "n_audio_ctx" in over:
            cfg = cfg.with_(encdec=dataclasses.replace(
                cfg.encdec, n_audio_ctx=over.pop("n_audio_ctx")))
        if "capacity_factor" in over:
            cfg = cfg.with_(moe=dataclasses.replace(
                cfg.moe, capacity_factor=over.pop("capacity_factor")))
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

    def placed(params, batch, mesh, rules):
        params = sharding.apply_shardings(
            params, sharding.param_shardings(params, mesh, rules))
        batch = sharding.apply_shardings(
            batch, sharding.batch_shardings(batch, mesh, rules))
        return params, batch

    for case, (arch, shape, cache_len, s, variant, rn) in \\
            spec["cases"].items():
        cfg = config(get_config, arch, variant, jnp.float32, spec)
        rules = spec["rules"][rn]
        mod, params = load(cfg, f"{arch}/{variant}")
        batch = {k: jnp.asarray(inp[f"{arch}/{variant}/serve/{k}"])
                 for k in spec["serve_keys"][f"{arch}/{variant}"]}
        batch["tokens"] = batch["tokens"][:, :s]
        steps = jnp.asarray(inp[f"{arch}/{variant}/serve/tokens"][
            :, s:s + spec["steps"]])
        mesh = mesh_of(shape)
        with logical.use_rules(mesh, rules):
            cache = mod.init_cache(cfg, spec["batch"], cache_len)
            params, batch = placed(params, batch, mesh, rules)
            cache = sharding.apply_shardings(
                cache, sharding.cache_shardings(cache, mesh, cfg, rules))
            if case in spec["forward"]:
                out[f"{case}/forward"] = np.asarray(jax.jit(
                    lambda p, b: mod.forward(cfg, p, b))(params, batch))
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
    for case, (arch, shape, variant, rn) in spec["train"].items():
        cfg = config(get_config, arch, variant, jnp.float32, spec,
                     remat="full")
        rules = spec["rules"][rn]
        mod, params = load(cfg, f"{arch}/{variant}")
        batch = {k: jnp.asarray(inp[f"{arch}/{variant}/train/{k}"])
                 for k in spec["train_keys"][f"{arch}/{variant}"]}
        mesh = mesh_of(shape)
        with logical.use_rules(mesh, rules):
            params, batch = placed(params, batch, mesh, rules)
            opt = adamw.init(tcfg.optimizer, params)
            p, o, m, _ = jax.jit(make_train_step(cfg, tcfg))(params, opt,
                                                             batch)
        out[f"{case}/loss"] = np.asarray(m["loss"])
        for i, x in enumerate(jax.tree.leaves(p)):
            out[f"{case}/param/{i:03d}"] = np.asarray(x)
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

        for case, (arch, shape, cache_len, s, variant, rn) in \\
                spec["cases"].items():
            mesh = mesh_of(shape)
            if not mesh.has_rank:
                continue
            cfg = config(get_config, arch, variant, torch.float32, spec)
            rules = spec["rules"][rn]
            mod = family_module(cfg)
            params = load(cfg, f"{arch}/{variant}")
            batch = {k: inp[f"{arch}/{variant}/serve/{k}"]
                     for k in spec["serve_keys"][f"{arch}/{variant}"]}
            steps = batch["tokens"][:, s:s + spec["steps"]]
            batch["tokens"] = batch["tokens"][:, :s]
            local = sharding.shard_params(params, mesh, rules,
                                          glu=cfg.mlp_glu)
            cache = sharding.shard_cache(
                mod.init_cache(cfg, spec["batch"], cache_len), mesh, cfg,
                rules)
            with logical.use_rules(mesh, rules):
                lb = sharding.local_batch(batch, mesh, 1, rules)
                rows = sharding.local_batch({"t": steps}, mesh, 1,
                                            rules)["t"]
                if case in spec["forward"]:
                    out[f"{case}/forward"] = mod.forward(cfg, local, lb)
                logits, cache = make_prefill(cfg)(local, lb, cache)
                out[f"{case}/logits/0"] = logits
                for i in range(spec["steps"]):
                    logits, cache = make_decode(cfg)(
                        local, rows[:, i:i + 1], cache, s + i)
                    out[f"{case}/logits/{i + 1}"] = logits
            whole = sharding.gather_cache(cache, mesh, cfg, rules)
            for j, leaf in enumerate(tree.leaves(whole)):
                out[f"{case}/cache/{j}"] = leaf
            out[f"{case}/data"] = np.array(mesh.index("data"))

        tcfg = TrainConfig(optimizer=adamw.AdamWConfig(**spec["opt"]),
                           microbatches=spec["mb"], loss_chunk=8)
        for case, (arch, shape, variant, rn) in spec["train"].items():
            mesh = mesh_of(shape)
            if not mesh.has_rank:
                continue
            cfg = config(get_config, arch, variant, torch.float32, spec,
                         remat="full", backend="torch")
            rules = spec["rules"][rn]
            params = load(cfg, f"{arch}/{variant}")
            batch = {k: inp[f"{arch}/{variant}/train/{k}"]
                     for k in spec["train_keys"][f"{arch}/{variant}"]}
            local = sharding.shard_params(params, mesh, rules,
                                          glu=cfg.mlp_glu)
            opt = adamw.init(tcfg.optimizer, local)
            with logical.use_rules(mesh, rules):
                lb = sharding.local_batch(batch, mesh, spec["mb"], rules)
                p, o, m, _ = make_train_step(cfg, tcfg)(local, opt, lb)
                p = sharding.gather_params(p, params, mesh, rules,
                                           glu=cfg.mlp_glu)
                mu = sharding.gather_params(o["mu"], params, mesh, rules,
                                            glu=cfg.mlp_glu)
            out[f"{case}/loss"] = m["loss"]
            for i, x in enumerate(tree.leaves(p)):
                out[f"{case}/param/{i:03d}"] = x
            for i, x in enumerate(tree.leaves(mu)):
                out[f"{case}/mu/{i:03d}"] = x
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


def _frontends(cfg, rng, rows):
    """The stub frontends' inputs a batch of ``rows`` carries."""
    out = {}
    if cfg.encdec is not None:
        out["audio_embeds"] = rng.standard_normal(
            (rows, cfg.encdec.n_audio_ctx, cfg.d_model)).astype(np.float32)
    if cfg.vision_prefix:
        out["vision_embeds"] = rng.standard_normal(
            (rows, cfg.vision_prefix, cfg.d_model)).astype(np.float32)
    return out


def _inputs(tmp, cases, forward, train):
    """The reference's reduced params (fp32) of each arch and variant,
    and seeded serving and train batches."""
    inp, serve_keys, train_keys = {}, {}, {}
    pairs = sorted({(c[0], c[4]) for c in cases.values()}
                   | {(c[0], c[2]) for c in train.values()})
    for i, (arch, variant) in enumerate(pairs):
        rng = np.random.default_rng(40 + i)
        cfg = _j_config(arch, variant)
        key = f"{arch}/{variant}"
        params = j_family(cfg).init(cfg, jax.random.PRNGKey(3))
        for j, leaf in enumerate(jax.tree.leaves(params)):
            inp[f"{key}/param/{j:03d}"] = np.asarray(leaf)
        serve = {"tokens": rng.integers(0, cfg.vocab_size, (B, 32)).astype(
            np.int32), **_frontends(cfg, rng, B)}
        toks = rng.integers(0, cfg.vocab_size,
                            (TRAIN_B, TRAIN_S + 1)).astype(np.int32)
        steps = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                 **_frontends(cfg, rng, TRAIN_B)}
        for kind, batch, keys in (("serve", serve, serve_keys),
                                  ("train", steps, train_keys)):
            keys[key] = sorted(batch)
            for k, x in batch.items():
                inp[f"{key}/{kind}/{k}"] = x
    np.savez(os.path.join(tmp, "inputs.npz"), **inp)
    with open(os.path.join(tmp, "cases.json"), "w") as f:
        json.dump({"cases": cases, "variants": VARIANTS, "rules": RULES,
                   "batch": B, "steps": STEPS, "forward": forward,
                   "train": train, "opt": OPT, "mb": MB,
                   "serve_keys": serve_keys, "train_keys": train_keys}, f)
    return inp


def run_worlds(tmp, cases=None, forward=(), train=None):
    """(the reference's results, each port rank's results) of the serving
    ``cases`` (``forward``: those that run it too) and the ``train``
    steps."""
    _inputs(tmp, cases or {}, forward, train or {})
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


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The serving cases' worlds (``run_worlds``)."""
    return run_worlds(str(tmp_path_factory.mktemp("seq_parallel_serve")),
                      CASES, FORWARD)


def _ranks_of(ranks, shape):
    return ranks[:shape[0] * shape[1]]


def _leaves(out, tag, kind):
    keys = sorted(k for k in out if k.startswith(f"{tag}/{kind}/"))
    return [out[k] for k in keys]


def _rel(got, want):
    assert got.shape == want.shape
    got, want = got.astype(np.float64), want.astype(np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


class TestServedUnderSequenceParallelism:
    @pytest.mark.parametrize("case", list(CASES))
    def test_logits_match_reference_meshed(self, worlds, case):
        """Each rank's prefill and decode logits (its batch rows) within
        1e-5 of max |logit| of the reference's under the same mesh and
        rules, the greedy tokens identical."""
        ref, ranks = worlds
        shape = CASES[case][1]
        for out in _ranks_of(ranks, shape):
            data = int(out[f"{case}/data"])
            n = B // shape[0]
            for i in range(STEPS + 1):
                want = ref[f"{case}/logits/{i}"][data * n:(data + 1) * n]
                got = out[f"{case}/logits/{i}"]
                assert _rel(got, want) <= TOL
                np.testing.assert_array_equal(got.argmax(-1),
                                              want.argmax(-1))

    @pytest.mark.parametrize("case", list(CASES))
    def test_gathered_cache_matches_reference(self, worlds, case):
        """The cache and state gathered from every rank's shard after the
        prefill and decode steps: zero where the reference's is and
        within TOL_CACHE of its max elsewhere."""
        ref, ranks = worlds
        j = 0
        while f"{case}/cache/{j}" in ref:
            want = ref[f"{case}/cache/{j}"]
            for out in _ranks_of(ranks, CASES[case][1]):
                got = out[f"{case}/cache/{j}"]
                np.testing.assert_array_equal(got == 0, want == 0)
                assert _rel(got, want) <= TOL_CACHE
            j += 1
        assert j > 0 and f"{case}/cache/{j}" not in ranks[0]

    @pytest.mark.parametrize("case", FORWARD)
    def test_forward_of_whole_leaves_matches_reference(self, worlds, case):
        """``forward`` over the prompt where the rules keep the
        attention's and MLP's leaves whole, or the embedding and the
        output weight: every rank's logits of its rows at every position
        within 1e-5 of the reference's."""
        ref, ranks = worlds
        for out in _ranks_of(ranks, CASES[case][1]):
            assert _rel(out[f"{case}/forward"], ref[f"{case}/forward"]) \
                <= TOL


# ---------------------------------------------------------------------------
# In process: the dry run's cells under the rules.
# ---------------------------------------------------------------------------

#: overrides of the reduced configs on the 256-rank mesh: RWKV-6 at 16
#: heads, which its model axis of 16 divides (ROADMAP item 7c.1 refuses
#: fewer)
DRYRUN_OVERRIDES = {"rwkv6-7b": {"d_model": 512, "n_heads": 16,
                                 "n_kv_heads": 16}}


@pytest.fixture
def small_cells(monkeypatch):
    """The dry run on reduced configs at shapes whose batch splits over
    the pod mesh's 16 data ranks and whose sequence splits over its 16
    model ranks."""
    monkeypatch.setattr(dryrun, "get_config", lambda arch, **ov:
                        reg.get_config(arch, reduced=True, **ov))
    for name, shape in (("train_4k", (32, 32, "train")),
                        ("prefill_32k", (64, 16, "prefill"))):
        monkeypatch.setitem(reg.SHAPES, name, reg.ShapeSpec(name, *shape))


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-7b",
                                  "whisper-tiny", "olmoe-1b-7b",
                                  "internvl2-1b"])
def test_dryrun_cells_under_sequence_parallelism(tmp_path, small_cells,
                                                 arch, shape):
    """``run_cell(..., "single", rules={"seq": "model"})`` counts rank 0's
    step of each family (``ok``): a reduce-scatter along the sequence at
    each exit, which the same cell without the rules does not have
    outside the FSDP gradients, and the same model FLOPs."""
    over = DRYRUN_OVERRIDES.get(arch)
    sp = dryrun.run_cell(arch, shape, "single", overrides=over, tag="_sp",
                         out_dir=str(tmp_path), rules=SEQ)
    base = dryrun.run_cell(arch, shape, "single", overrides=over,
                           out_dir=str(tmp_path))
    assert sp["status"] == "ok" and base["status"] == "ok", sp.get("reason")
    assert sp["model_flops_total"] == base["model_flops_total"]
    assert sp["collective_bytes"].get("reduce-scatter", 0) > \
        base["collective_bytes"].get("reduce-scatter", 0)
