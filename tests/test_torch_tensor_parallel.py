"""Training on a mesh: the port's tensor-parallel, FSDP and data-parallel
train step against the reference's, the launcher on a mesh, and the dry
run's pod meshes.

The multi-rank cases run in two subprocesses on the same numpy inputs,
as ``tests/test_torch_distributed.py`` runs its own: the reference on 8
forced host devices, each step once on one device and once jitted under
``logical.use_rules(make_host_mesh(model=...))`` with its parameters and
batch placed by ``param_shardings`` and ``batch_shardings``; the port in
a gloo world of 8 CPU ranks (``launch.mesh.run_world``), each rank
holding its shards (``sharding.shard_params``) and its rows of each
microbatch (``sharding.local_batch``).  Reduced configurations in fp32,
remat "full", 2 microbatches of 4 x 16 tokens, one AdamW step: the loss
within 1e-5 relative and every gathered leaf (updated parameters and
first moment) within 1e-5 of its max, against both reference steps.

AdamW's eps is 1e-2 here.  At the first step the update is g / (|g| +
eps): with eps at its default 1e-8 an element whose gradient is a few
ulps from 0 takes a unit step whose sign the last bits decide, and a
zero-initialized leaf (gemma2's norm scales) is then all update, so
rounding in the gradient moves it by 1e-3 of its max between the
reference's own one-device and meshed steps (1.6e-5 at eps 1e-4).  At
1e-2 the update is a smooth function of the gradient; the first moment,
the gradient itself, is held at 1e-5 at any eps.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.distributed import sharding as j_sharding      # noqa: E402
from repro.launch.mesh import compat_abstract_mesh        # noqa: E402
from repro.models.base import family_module as j_family   # noqa: E402
from repro_torch.configs import registry as reg           # noqa: E402
from repro_torch.core import tree                         # noqa: E402
from repro_torch.distributed import logical, sharding     # noqa: E402
from repro_torch.launch import dryrun, perf_iter          # noqa: E402
from repro_torch.launch import train as launch_train      # noqa: E402
from repro_torch.launch.mesh import rank_view             # noqa: E402
from repro_torch.models.base import family_module         # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
WORLD_TIMEOUT = 300          # seconds, each subprocess
B, S, MB = 8, 16, 2
OPT = dict(lr=3e-4, warmup_steps=1, total_steps=10, eps=1e-2)
ARCHS = ("yi-6b", "olmoe-1b-7b", "gemma2-2b")
#: case -> (arch, (data, model), rules); the reference steps each case
#: meshed when it has a mesh of its own, and every arch on one device
CASES = {
    "yi": ("yi-6b", (4, 2), None),
    # 2 KV heads on 4: every rank computes the KV head its q head reads
    "yi_kv": ("yi-6b", (2, 4), None),
    # 4 q heads on 8: the q columns gathered, every head on every rank
    "yi_q": ("yi-6b", (1, 8), None),
    "olmoe": ("olmoe-1b-7b", (4, 2), None),
    "gemma": ("gemma2-2b", (4, 2), None),
    "gemma_sp": ("gemma2-2b", (4, 2), {"seq": "model"}),
}
REF_MESHED = ("yi", "olmoe", "gemma", "gemma_sp")
LAUNCH = ["--reduced", "--device", "cpu", "--steps", "4", "--global-batch",
          "8", "--seq-len", "16", "--microbatches", "2", "--log-every", "1",
          "--ckpt-every", "2"]

_REFERENCE_PROG = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys
    sys.path.insert(0, sys.argv[1])
    import json
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.configs.registry import get_config
    from repro.distributed import logical, sharding
    from repro.launch.mesh import make_host_mesh
    from repro.models.base import family_module
    from repro.optim import adamw
    from repro.training.train_step import TrainConfig, make_train_step

    tmp = sys.argv[2]
    spec = json.load(open(os.path.join(tmp, "cases.json")))
    inp = dict(np.load(os.path.join(tmp, "inputs.npz")))
    out = {}
    tcfg = TrainConfig(optimizer=adamw.AdamWConfig(**spec["opt"]),
                       microbatches=spec["mb"], loss_chunk=8)

    def setup(arch):
        cfg = get_config(arch, reduced=True).with_(
            dtype=jnp.float32, kv_cache_dtype=jnp.float32, remat="full")
        like = jax.eval_shape(lambda k: family_module(cfg).init(cfg, k),
                              jax.random.PRNGKey(0))
        n = len(jax.tree.leaves(like))
        params = jax.tree.unflatten(jax.tree.structure(like), [
            jnp.asarray(inp[f"{arch}/param/{i:03d}"]) for i in range(n)])
        batch = {k: jnp.asarray(inp[f"{arch}/{k}"])
                 for k in ("tokens", "labels")}
        return cfg, params, batch

    def record(tag, p, o, m):
        out[f"{tag}/loss"] = np.asarray(m["loss"])
        for i, x in enumerate(jax.tree.leaves(p)):
            out[f"{tag}/param/{i:03d}"] = np.asarray(x)
        for i, x in enumerate(jax.tree.leaves(o["mu"])):
            out[f"{tag}/mu/{i:03d}"] = np.asarray(x)

    for arch in spec["archs"]:
        cfg, params, batch = setup(arch)
        step = jax.jit(make_train_step(cfg, tcfg))
        p, o, m, _ = step(params, adamw.init(tcfg.optimizer, params), batch)
        record(f"{arch}/one", p, o, m)
    for case in spec["meshed"]:
        arch, shape, rules = spec["cases"][case]
        cfg, params, batch = setup(arch)
        mesh = make_host_mesh(model=shape[1])
        assert tuple(mesh.devices.shape) == tuple(shape)
        with logical.use_rules(mesh, rules):
            params = sharding.apply_shardings(
                params, sharding.param_shardings(params, mesh, rules))
            batch = sharding.apply_shardings(
                batch, sharding.batch_shardings(batch, mesh, rules))
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


    def rank_main(world, tmp):
        torch.set_num_threads(1)
        import torch.distributed as dist
        from repro_torch.configs.registry import get_config
        from repro_torch.core import tree
        from repro_torch.distributed import logical, sharding
        from repro_torch.distributed import tensor_parallel as tp
        from repro_torch.launch import train as launch_train
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.base import family_module
        from repro_torch.optim import adamw
        from repro_torch.training.train_step import (TrainConfig,
                                                     leaf_specs,
                                                     make_train_step)

        spec = json.load(open(os.path.join(tmp, "cases.json")))
        inp = {k: torch.from_numpy(v) for k, v in
               np.load(os.path.join(tmp, "inputs.npz")).items()}
        out = {}
        tcfg = TrainConfig(optimizer=adamw.AdamWConfig(**spec["opt"]),
                           microbatches=spec["mb"], loss_chunk=8)

        def setup(arch):
            cfg = get_config(arch, reduced=True).with_(
                dtype=torch.float32, kv_cache_dtype=torch.float32,
                remat="full", backend="torch")
            like = family_module(cfg).init(cfg, None, "meta")
            n = len(tree.leaves(like))
            # copies: a leaf the rules keep whole is its own shard, and
            # the step writes into it
            params = tree.unflatten(like, [
                inp[f"{arch}/param/{i:03d}"].clone() for i in range(n)])
            batch = {k: inp[f"{arch}/{k}"] for k in ("tokens", "labels")}
            return cfg, params, batch

        for case, (arch, shape, rules) in spec["cases"].items():
            cfg, params, batch = setup(arch)
            mesh = make_mesh(shape, ("data", "model"))
            local = sharding.shard_params(params, mesh, rules,
                                          glu=cfg.mlp_glu)
            if case == "yi":
                back = sharding.gather_params(local, params, mesh, rules,
                                              glu=cfg.mlp_glu)
                out["glu/roundtrip"] = np.array(all(
                    torch.equal(a, b) for a, b in
                    zip(tree.leaves(back), tree.leaves(params))))
                wi = local["layers"][0]["mlp"]["wi"][0]
                out["glu/local_wi"] = wi.clone()
                with logical.use_rules(mesh, rules):
                    specs = leaf_specs(cfg, local, mesh)
                    pl = tp.current()
                    out["norm/mesh"] = adamw.global_norm(
                        tree.leaves(local), pl, specs)
                out["norm/one"] = adamw.global_norm(params)
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

        # the launcher on (4, 2): a checkpoint at 2 and 4, then a resume
        # from 2 on the same mesh
        argv = spec["launch"] + ["--mesh", "host", "--model-parallel", "2",
                                 "--ckpt-dir", os.path.join(tmp, "ckpt")]
        full = launch_train.main(argv)
        dist.barrier()
        if world.rank == 0:
            last = os.path.join(tmp, "ckpt", "step_00000004")
            os.rename(last, last.replace("step_", "held_"))
        dist.barrier()
        resumed = launch_train.main(argv)
        out["launch/full"] = np.array(full.losses)
        out["launch/resumed"] = np.array(resumed.losses)
        out["launch/start"] = np.array(resumed.start)
        out["launch/same_shards"] = np.array(all(
            torch.equal(a, b) for a, b in zip(tree.leaves(full.params),
                                              tree.leaves(resumed.params))))
        np.savez(os.path.join(tmp, f"rank{world.rank}.npz"),
                 **{k: np.asarray(v) for k, v in out.items()})


    if __name__ == "__main__":
        run_world(rank_main, 8, (sys.argv[2],), device="cpu",
                  rendezvous=os.path.join(sys.argv[2], "rendezvous"),
                  timeout=float(sys.argv[3]))
""")


def _inputs(tmp):
    """The reference's reduced params (fp32) of each arch and a seeded
    batch, for both worlds."""
    inp = {}
    for i, arch in enumerate(ARCHS):
        cfg = j_get_config(arch, reduced=True).with_(dtype=jnp.float32)
        params = j_family(cfg).init(cfg, jax.random.PRNGKey(1))
        for j, leaf in enumerate(jax.tree.leaves(params)):
            inp[f"{arch}/param/{j:03d}"] = np.asarray(leaf)
        toks = np.random.default_rng(i).integers(
            0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        inp[f"{arch}/tokens"], inp[f"{arch}/labels"] = toks[:, :-1], \
            toks[:, 1:]
    np.savez(os.path.join(tmp, "inputs.npz"), **inp)
    with open(os.path.join(tmp, "cases.json"), "w") as f:
        json.dump({"archs": ARCHS, "cases": CASES, "meshed": REF_MESHED,
                   "opt": OPT, "mb": MB, "launch": LAUNCH}, f)
    return inp


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """(inputs, the reference's results, each port rank's results, tmp)."""
    tmp = str(tmp_path_factory.mktemp("mesh_worlds"))
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
    return inp, ref, ranks, tmp


def _leaves(out, tag, kind):
    keys = sorted(k for k in out if k.startswith(f"{tag}/{kind}/"))
    return [out[k] for k in keys]


def _leaf_rel(ours, ref):
    """The largest distance of a leaf from the reference's, over its max."""
    assert len(ours) == len(ref) > 0
    worst = 0.0
    for o, r in zip(ours, ref):
        assert o.shape == r.shape
        o, r = o.astype(np.float64), r.astype(np.float64)
        worst = max(worst, np.abs(o - r).max() / max(np.abs(r).max(),
                                                     1e-30))
    return worst


class TestMeshedStep:
    @pytest.mark.parametrize("case", list(CASES))
    def test_step_matches_reference_on_one_device(self, worlds, case):
        """Every rank's step, gathered, against the reference's step on
        one device: the loss and each updated parameter and first
        moment."""
        _, ref, ranks, _ = worlds
        arch = CASES[case][0]
        loss = float(ref[f"{arch}/one/loss"])
        for out in ranks:
            assert abs(float(out[f"{case}/loss"]) - loss) <= 1e-5 * abs(loss)
            for kind in ("param", "mu"):
                assert _leaf_rel(_leaves(out, case, kind),
                                 _leaves(ref, f"{arch}/one", kind)) <= 1e-5

    @pytest.mark.parametrize("case", REF_MESHED)
    def test_step_matches_reference_meshed(self, worlds, case):
        """Against the reference's step jitted under the same mesh and
        rules, its leaves placed by ``param_shardings``."""
        _, ref, ranks, _ = worlds
        loss = float(ref[f"{case}/mesh/loss"])
        for out in ranks:
            assert abs(float(out[f"{case}/loss"]) - loss) <= 1e-5 * abs(loss)
            for kind in ("param", "mu"):
                assert _leaf_rel(_leaves(out, case, kind),
                                 _leaves(ref, f"{case}/mesh", kind)) <= 1e-5

    def test_sequence_parallel_rules_equal_the_step_without(self, worlds):
        """``g2_seq_parallel``'s rules ({"seq": "model"}: the residual
        stream sharded along the sequence between blocks) give gemma2-2b's
        step without them."""
        _, _, ranks, _ = worlds
        for out in ranks:
            loss = float(out["gemma/loss"])
            assert abs(float(out["gemma_sp/loss"]) - loss) <= 1e-6 * loss
            for kind in ("param", "mu"):
                assert _leaf_rel(_leaves(out, "gemma_sp", kind),
                                 _leaves(out, "gemma", kind)) <= 1e-6

    def test_glu_shards_pair_gate_and_up_and_gather_back(self, worlds):
        """Gathering each rank's shards gives the tree back bit for bit;
        a rank's ``wi`` shard holds the gate columns and the up columns
        of its slice of d_ff, paired."""
        inp, _, ranks, _ = worlds
        cfg = reg.get_config("yi-6b", reduced=True)
        like = family_module(cfg).init(cfg, None, "meta")
        paths = [tree.path_str(p) for p, _ in tree.flatten_with_path(like)]
        wi = inp[f"yi-6b/param/{paths.index('layers/0/mlp/wi'):03d}"][0]
        ff, m = cfg.d_ff, 2
        cols = ff // m
        for r, out in enumerate(ranks):
            assert bool(out["glu/roundtrip"])
            data, model = divmod(r, m)
            rows = slice(data * wi.shape[0] // 4, (data + 1) * wi.shape[0]
                         // 4)
            gate = wi[rows, model * cols:(model + 1) * cols]
            up = wi[rows, ff + model * cols:ff + (model + 1) * cols]
            np.testing.assert_array_equal(out["glu/local_wi"],
                                          np.concatenate([gate, up], 1))

    def test_global_norm_counts_each_leaf_once(self, worlds):
        """The norm from each rank's shards of a tree equals the whole
        tree's: a leaf replicated over an axis counted once."""
        _, _, ranks, _ = worlds
        for out in ranks:
            assert abs(float(out["norm/mesh"]) - float(out["norm/one"])) \
                <= 1e-6 * float(out["norm/one"])


class TestLauncherOnAMesh:
    def test_resumes_bit_for_bit_on_the_same_mesh(self, worlds):
        """``--mesh host --model-parallel 2`` over 8 ranks, 4 steps with
        checkpoints at 2 and 4; from step 2 a second run on the same mesh
        takes steps 3-4 with the first run's losses and shards, bit for
        bit."""
        _, _, ranks, _ = worlds
        for out in ranks:
            full = out["launch/full"]
            assert len(full) == 4 and np.isfinite(full).all()
            assert int(out["launch/start"]) == 2
            np.testing.assert_array_equal(out["launch/resumed"], full[2:])
            assert bool(out["launch/same_shards"])

    def test_checkpoint_holds_the_reference_layout(self, worlds):
        """The mesh run's checkpoint holds whole leaves, those of the
        reference's state, and a one-process launcher resumes it."""
        _, _, ranks, tmp = worlds
        ckpt = os.path.join(tmp, "ckpt_one")
        shutil.copytree(os.path.join(tmp, "ckpt"), ckpt)
        shutil.rmtree(os.path.join(ckpt, "step_00000004"))   # the resume's
        index = json.load(open(os.path.join(ckpt, "step_00000002",
                                            "index.json")))
        cfg = j_get_config("yi-6b", reduced=True).with_(dtype=jnp.float32)
        params = jax.eval_shape(lambda k: j_family(cfg).init(cfg, k),
                                jax.random.PRNGKey(0))
        shapes = [list(x.shape) for x in jax.tree.leaves(params)]
        got = [e["shape"] for e in index["leaves"]
               if e["path"].startswith("params/")]
        assert got == shapes
        one = launch_train.main(LAUNCH + ["--ckpt-dir", ckpt])
        assert one.start == 2 and len(one.losses) == 2
        mesh = ranks[0]["launch/full"][2:]
        assert np.abs(np.array(one.losses) - mesh).max() <= 1e-5 * np.abs(
            mesh).max()


# ---------------------------------------------------------------------------
# In process: refusals, the shards' arithmetic, the dry run's pod meshes.
# ---------------------------------------------------------------------------

def test_pod_mesh_needs_its_world():
    with pytest.raises(SystemExit, match="256 ranks"):
        launch_train.main(LAUNCH[:3] + ["--mesh", "single"])
    with pytest.raises(SystemExit, match="512 ranks"):
        launch_train.main(LAUNCH[:3] + ["--mesh", "multi"])


def test_glu_shard_of_each_coordinate():
    """``shard_leaf`` on a rank view, no world: the (gate | up) columns
    of a GLU ``wi`` split pairwise, every other leaf contiguously; the
    shards' sizes are the reference's."""
    d, ff = 8, 12
    wi = torch.arange(d * 2 * ff, dtype=torch.float32).reshape(d, 2 * ff)
    for r in range(4):
        mesh = rank_view((2, 2), ("data", "model"), divmod(r, 2))
        with logical.use_rules(mesh):
            spec = sharding.spec_of("wi", wi.shape)
        assert spec == ("data", "model")
        got = sharding.shard_leaf(wi, spec, mesh, glu=True)
        data, model = divmod(r, 2)
        rows = slice(data * 4, data * 4 + 4)
        want = torch.cat([wi[rows, model * 6:model * 6 + 6],
                          wi[rows, ff + model * 6:ff + model * 6 + 6]], 1)
        assert torch.equal(got, want)
        plain = sharding.shard_leaf(wi, spec, mesh)
        assert torch.equal(plain, wi[rows, model * 12:model * 12 + 12])


def test_leaves_must_be_the_ranks_shards():
    """On a rank view, on ``meta``: a leaf that is not the rank's shard
    under the active rules raises, in the forward and in the train
    step's specs (no leaf is taken as whole by its shape); OLMoE placed
    by ``EXPERT_PARALLEL_RULES`` serves under them, its dense leaves
    whole and its experts split."""
    from repro_torch.training.train_step import leaf_specs
    cfg = reg.get_config("olmoe-1b-7b", reduced=True).with_(
        dtype=torch.float32)
    mod = family_module(cfg)
    view = rank_view((1, 2), ("data", "model"))
    whole = mod.init(cfg, None, "meta")
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32,
                                   device="meta")}
    with logical.use_rules(view):
        with pytest.raises(ValueError, match="rank's shard"):
            mod.forward(cfg, whole, batch)
        with pytest.raises(ValueError, match="rank's shard"):
            leaf_specs(cfg, whole, view)
    ep = sharding.shard_params(whole, view, sharding.EXPERT_PARALLEL_RULES,
                               glu=cfg.mlp_glu)
    layer = ep["layers"][0]
    assert layer["attn"]["wq"].shape == whole["layers"][0]["attn"]["wq"].shape
    assert (layer["moe"]["experts_wi"].shape[1]
            == cfg.moe.n_experts // 2)
    with logical.use_rules(view, sharding.EXPERT_PARALLEL_RULES):
        logits = mod.forward(cfg, ep, batch)
        assert len(leaf_specs(cfg, ep, view)) == len(tree.leaves(ep))
    assert logits.shape == (2, 8, cfg.padded_vocab)


def test_sequence_parallelism_is_decided_once_a_pass():
    """Under ``{"seq": "model"}`` a forward over a sequence the model
    axis divides shards the residual stream for the pass (its hidden
    states are the rank's share), a decode step of one token does not,
    and a prefill's logits are whole."""
    from repro_torch.distributed import tensor_parallel as tp
    cfg = reg.get_config("yi-6b", reduced=True).with_(dtype=torch.float32)
    mod = family_module(cfg)
    view = rank_view((1, 2), ("data", "model"))
    params = sharding.shard_params(mod.init(cfg, None, "meta"), view,
                                   {"seq": "model"}, glu=cfg.mlp_glu)
    tokens = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    with logical.use_rules(view, {"seq": "model"}):
        hidden = mod.forward(cfg, params, {"tokens": tokens},
                             return_hidden=True)
        assert tp.current().seq and hidden.shape == (2, 4, cfg.d_model)
        cache = sharding.shard_cache(
            mod.init_cache(cfg, 2, 16, device="meta"), view, cfg,
            {"seq": "model"})
        logits, cache = mod.prefill(cfg, params, {"tokens": tokens}, cache)
        assert not tp.current().seq
        assert logits.shape == (2, cfg.padded_vocab)
        logits, _ = mod.decode_step(cfg, params, tokens[:, :1], cache, 8)
        assert not tp.current().seq
        assert logits.shape == (2, cfg.padded_vocab)
    assert tp.current() is None


@pytest.fixture
def pod_grid(monkeypatch):
    """The dry run on reduced configs at shapes whose batch splits over
    the pod meshes' 16 and 32 data ranks."""
    monkeypatch.setattr(dryrun, "get_config", lambda arch, **ov:
                        reg.get_config(arch, reduced=True, **ov))
    for name, shape in (("train_4k", (32, 64, "train")),
                        ("prefill_32k", (64, 32, "prefill")),
                        ("decode_32k", (64, 32, "decode"))):
        monkeypatch.setitem(reg.SHAPES, name, reg.ShapeSpec(name, *shape))


def _reference_specs(arch, mesh_case):
    cfg = j_get_config(arch, reduced=True)
    params = jax.eval_shape(lambda k: j_family(cfg).init(cfg, k),
                            jax.random.PRNGKey(0))
    sh = j_sharding.param_shardings(params, compat_abstract_mesh(*mesh_case))
    return [(x.shape, tuple(s.spec), x.dtype.itemsize) for x, s in
            zip(jax.tree.leaves(params), jax.tree.leaves(sh))]


def _local_bytes(shape, spec, sizes, itemsize):
    n = 1
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        names = (entry,) if isinstance(entry, str) else tuple(entry or ())
        n *= dim // math.prod(sizes[a] for a in names)
    return n * itemsize


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
@pytest.mark.parametrize("arch", ["yi-6b", "gemma2-2b", "deepseek-67b",
                                  "internvl2-1b", "olmoe-1b-7b",
                                  "arctic-480b"])
def test_pod_train_cells_count_rank_zero(tmp_path, pod_grid, arch,
                                         mesh_name):
    """Every dense and MoE train cell is ``ok`` on both pod meshes: the
    reference's per-chip fields, and argument bytes equal to rank 0's
    shards under the reference's own specs (params in bf16, master, mu
    and nu in fp32, the step, its batch rows)."""
    r = dryrun.run_cell(arch, "train_4k", mesh_name, out_dir=str(tmp_path))
    sizes_names = dryrun.MESHES[mesh_name]
    sizes = dict(zip(sizes_names[1], sizes_names[0]))
    chips = math.prod(sizes.values())
    assert r["status"] == "ok" and (r["chips"], r["mesh"]) == (chips,
                                                               mesh_name)
    assert r["roofline"]["model_flops_per_chip"] == pytest.approx(
        r["model_flops_total"] / chips, rel=1e-12)
    cfg = reg.get_config(arch, reduced=True)
    want = sum(_local_bytes(shape, spec, sizes, size + 3 * 4)
               for shape, spec, size in _reference_specs(arch, sizes_names))
    spec = reg.SHAPES["train_4k"]
    rows = spec.global_batch // (chips // sizes["model"])
    want += 4 + 2 * rows * spec.seq_len * 4
    if cfg.vision_prefix:
        want += rows * cfg.vision_prefix * cfg.d_model * 4
    assert r["memory"]["argument_bytes"] == want
    assert set(r["collective_bytes"]) == {"all-gather", "all-reduce",
                                          "reduce-scatter", "total"}


def _reckoned_collectives(mesh_name):
    """Collective bytes of rank 0's train step of reduced yi-6b (d 64, 4
    q heads and 2 KV heads of 16, d_ff 128, vocab 512, 3 layers, bf16,
    remat "full") at ``pod_grid``'s 64 x 32 tokens, one microbatch of R
    rows a rank, one loss chunk.  On a model axis of 16 the rank's 4 q
    columns are a quarter of a head, so q is all-gathered over model
    (every head on every rank), and so are the KV weights.

    * all-gather: a layer's weights over data, whole in d (d 4q/16, d 2kv
      /16 twice, 4q/16 d, d 2ff/16, ff/16 d), and over model q (R S 4q)
      and the KV weights (d 2kv twice), in the forward and again in
      remat's recompute; the embedding and the output weight once each.
    * reduce-scatter: each of those once in the backward, at a 16th.
    * all-reduce: an activation (R S d, in fp32) at each of a layer's two
      exits in the forward, the attention's in the recompute (it stops at
      the last tensor the backward needs, before the MLP's exit); one
      (bf16) at each of the two entries in the backward, the embedding's
      sum and the loss's entry in the backward; the loss chunk's row max, sum of exponentials and
      label logit (R S fp32) in the forward and its recompute; over the
      batch axes the token count, the loss, its nll and z, and each norm
      scale's gradient (bf16), and over every axis the clipping norm."""
    cfg = reg.get_config("yi-6b", reduced=True)
    d, q, kv, ff, v, n = (cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff,
                          cfg.padded_vocab, cfg.n_layers)
    sizes = dict(zip(dryrun.MESHES[mesh_name][1], dryrun.MESHES[mesh_name][0]))
    m, data = sizes["model"], sizes["data"]
    batch_axes = [a for a in ("pod", "data") if a in sizes]
    spec = reg.SHAPES["train_4k"]
    rows, s = spec.global_batch // math.prod(sizes[a] for a in batch_axes), \
        spec.seq_len
    e, act = 2, rows * s * d * 2         # bf16; the exits' sums in fp32
    fsdp = (d * q + 2 * d * kv + q * d + d * 2 * ff + ff * d) // m * e
    model = (rows * s * q + 2 * d * kv) * e
    vocab = v // m * d * e
    gather = n * 2 * (fsdp + model) + 2 * vocab
    scatter = n * (fsdp // data + model // m) + 2 * vocab // data
    norms = (2 * n * d + d) * e
    reduce = (n * (3 * 2 * act + 2 * act) + act + act + 2 * 3 * rows * s * 4
              + len(batch_axes) * 4 * 4 + norms * (data > 1)
              + 4 * len(sizes))
    out = {"all-gather": gather, "reduce-scatter": scatter,
           "all-reduce": reduce}
    if "pod" in sizes:            # every leaf's gradient over the pods
        out["all-reduce"] += sum(
            _local_bytes(shape, spec_, sizes, size)
            for shape, spec_, size in _reference_specs(
                "yi-6b", dryrun.MESHES[mesh_name]))
    out["total"] = sum(out.values())
    return out


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
def test_pod_train_cell_collectives_as_reckoned(tmp_path, pod_grid,
                                                mesh_name):
    r = dryrun.run_cell("yi-6b", "train_4k", mesh_name,
                        out_dir=str(tmp_path))
    assert r["collective_bytes"] == _reckoned_collectives(mesh_name)


def _reference_cache_specs(arch, shape_name, mesh_case):
    """The reference's cache of a cell, placed by its ``cache_shardings``:
    (shape, spec, itemsize) a leaf."""
    cfg = j_get_config(arch, reduced=True)
    spec = reg.SHAPES[shape_name]
    cache = jax.eval_shape(lambda: j_family(cfg).init_cache(
        cfg, spec.global_batch, spec.seq_len))
    sh = j_sharding.cache_shardings(cache, compat_abstract_mesh(*mesh_case),
                                    cfg)
    return [(x.shape, tuple(s.spec), x.dtype.itemsize) for x, s in
            zip(jax.tree.leaves(cache), jax.tree.leaves(sh))]


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["yi-6b", "gemma2-2b", "internvl2-1b",
                                  "deepseek-67b", "arctic-480b"])
def test_pod_serving_cells_shard_the_cache_sequence(tmp_path, pod_grid, arch,
                                                    shape, mesh_name):
    """The prefill and decode cells of the five configurations whose KV
    heads do not divide the model axis of 16 (2 KV heads reduced; at full
    size 4, 4, 2, 8 and 8) count on both pod meshes: the cache holds
    every KV head at the rank's 64 / 16 positions, and a rank's argument
    bytes equal its share of the reference's params and cache under
    ``param_shardings`` and ``cache_shardings``, and its batch rows."""
    r = dryrun.run_cell(arch, shape, mesh_name, out_dir=str(tmp_path))
    assert r["status"] == "ok", r.get("reason")
    sizes_names = dryrun.MESHES[mesh_name]
    sizes = dict(zip(sizes_names[1], sizes_names[0]))
    cfg = reg.get_config(arch, reduced=True)
    cache = _reference_cache_specs(arch, shape, sizes_names)
    assert all(sp[2:4] == (None, "model") for _, sp, _ in cache)
    want = sum(_local_bytes(shape_, spec_, sizes, size)
               for shape_, spec_, size in
               _reference_specs(arch, sizes_names) + cache)
    spec = reg.SHAPES[shape]
    rows = spec.global_batch // (sizes["data"] * sizes.get("pod", 1))
    if spec.mode == "prefill":
        want += rows * spec.seq_len * 4
        if cfg.vision_prefix:
            want += rows * cfg.vision_prefix * cfg.d_model * 4
    else:
        want += rows * 4
    assert r["memory"]["argument_bytes"] == want
    assert r["kernels"]["fused_matmul"]["calls"] > 0


def test_pod_decode_cell_collectives_as_reckoned(tmp_path, pod_grid):
    """yi-6b's decode_32k cell on ``single``, rank 0 (reduced: d 64, 4 q
    heads and 2 KV heads of 16, d_ff 128, vocab 512, 3 layers, bf16; 2
    rows a rank).  4 q heads on 16 are a quarter of a head a rank, so q
    is gathered over model (every head on every rank) and so are the KV
    weights (every KV head on every rank).

    * all-gather: a layer's weights over data (d 4q/16, d 2kv/16 twice,
      4q/16 d, d 2ff/16, ff/16 d), q over model (2 x 4q) and the KV
      weights (d 2kv, twice); the embedding and the output weight over
      data (vocab/16 x d each), the logits over model (2 x vocab, fp32).
    * all-reduce, fp32: a layer's row max (2 x 4 heads), sum of
      exponentials with P·V (2 x 4 x (1 + 16)) and two exits (2 x d);
      the embedding's sum (2 x d, bf16)."""
    r = dryrun.run_cell("yi-6b", "decode_32k", "single",
                        out_dir=str(tmp_path))
    d, q, kv, ff, v, n, rows, e = 64, 64, 32, 128, 512, 3, 2, 2
    layer = ((d * q + 2 * d * kv + q * d + d * 2 * ff + ff * d) // 16 * e
             + rows * q * e + 2 * d * kv * e)
    gather = n * layer + 2 * v // 16 * d * e + rows * v * 4
    reduce = (n * (rows * 4 * 4 + rows * 4 * 17 * 4 + 2 * rows * d * 4)
              + rows * d * e)
    assert r["collective_bytes"] == {"all-gather": gather,
                                     "all-reduce": reduce,
                                     "total": gather + reduce}


def test_pod_serving_cells_whose_kv_heads_divide(tmp_path, pod_grid,
                                                 monkeypatch):
    """A prefill and a decode cell whose KV heads divide the model axis
    count on both meshes (reduced OLMoE widened to 16 KV heads of 16)."""
    monkeypatch.setattr(dryrun, "get_config", lambda arch, **ov:
                        reg.get_config(arch, reduced=True, **ov).with_(
                            n_heads=16, n_kv_heads=16, head_dim=16,
                            d_model=256))
    for shape in ("prefill_32k", "decode_32k"):
        for mesh_name in ("single", "multi"):
            r = dryrun.run_cell("olmoe-1b-7b", shape, mesh_name,
                                out_dir=str(tmp_path))
            assert r["status"] == "ok", r.get("reason")
            assert r["collective_bytes"]["all-reduce"] > 0
            assert r["kernels"]["fused_matmul"]["calls"] > 0


def test_perf_iter_runs_sequence_parallel_on_the_pod(tmp_path, pod_grid):
    """``g2_seq_parallel`` runs on ``single`` (its baseline too): the
    residual stream sharded along the sequence moves fewer bytes a rank;
    the FLOPs stay."""
    names = {e["name"]: e for e in perf_iter.EXPERIMENTS}
    got = perf_iter.run_experiment(names["g2_seq_parallel"],
                                   out_dir=str(tmp_path))
    assert got["status"] == "ok" and got["mesh"] == "single"
    b, a = got["before"], got["after"]
    assert a["bytes_per_chip"] < b["bytes_per_chip"]
    assert a["flops_per_chip"] == pytest.approx(b["flops_per_chip"],
                                                rel=0.05)
    assert (tmp_path / "single_g2_seq_parallel" /
            "gemma2-2b__train_4k.json").exists()


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("sizes", [{"data": 2, "model": 2},
                                   {"data": 4, "model": 1},
                                   {"data": 16, "model": 16},
                                   {"pod": 2, "data": 16, "model": 16}],
                         ids=lambda s: "x".join(map(str, s.values())))
def test_chip_smoke_reckons_the_mesh_step(sizes):
    """``chip_smoke.py``'s reckonings of phase ``dist-train`` (collective
    bytes by kind, K1's launches) against the meta count of one rank's
    step of reduced yi-6b (bf16, remat "full", 2 microbatches, one loss
    chunk) on a rank view; the card's count is held to the meta count
    there (``dist-dryrun``)."""
    from repro_torch.optim import adamw
    from repro_torch.training.train_step import (TrainConfig,
                                                 abstract_state)
    smoke = _chip_smoke()
    cfg = reg.get_config("yi-6b", reduced=True).with_(backend="torch")
    seq, mb = 32, 2
    n_batch = sizes.get("pod", 1) * sizes["data"]
    tcfg = TrainConfig(microbatches=mb, loss_chunk=seq)
    view = rank_view(tuple(sizes.values()), tuple(sizes))
    with logical.use_rules(view):
        params = sharding.shard_params(abstract_state(cfg, tcfg)[0], view,
                                       glu=cfg.mlp_glu)
        batch = sharding.local_batch(
            {k: torch.empty((2 * mb * n_batch, seq), dtype=torch.int32,
                            device="meta") for k in ("tokens", "labels")},
            view, mb)
        cost, _, _ = dryrun.count_step(
            dryrun.step_fn(cfg, "train", tcfg),
            (params, adamw.init(tcfg.optimizer, params), batch), True)
    got = {**cost.per_collective, "total": cost.collective_bytes}
    assert got == smoke._mesh_train_collectives(cfg, sizes, 2, seq, mb, 4)
    assert cost.kernels["fused_matmul"]["calls"] == \
        mb * smoke._train_k1_calls(cfg, 1)


@pytest.mark.parametrize("sizes", [{"data": 1, "model": 8},
                                   {"data": 1, "model": 4},
                                   {"data": 2, "model": 4},
                                   {"data": 16, "model": 16}],
                         ids=lambda s: "x".join(map(str, s.values())))
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_chip_smoke_reckons_the_seq_decode_step(sizes, dtype):
    """``chip_smoke.py``'s reckonings of phase ``dist-seq`` (a decode
    step's collective bytes by kind; K1's and K2's launches of a prefill
    and decode steps) against the meta count of one rank's steps of
    reduced yi-6b, whose 2 KV heads the model axis does not divide, on a
    rank view; the card's count is held to the meta count there."""
    from repro_torch.serving.engine import make_decode, make_prefill
    smoke = _chip_smoke()
    cfg = reg.get_config("yi-6b", reduced=True)
    if dtype == "fp32":
        cfg = cfg.with_(dtype=torch.float32, kv_cache_dtype=torch.float32)
    rows, s, length = 2, 12, 16 * sizes["model"]
    view = rank_view(tuple(sizes.values()), tuple(sizes))
    mod = family_module(cfg)
    with logical.use_rules(view):
        params = sharding.shard_params(mod.init(cfg, None, "meta"), view,
                                       glu=cfg.mlp_glu)
        cache = sharding.shard_cache(mod.init_cache(
            cfg, rows * sizes["data"], length, device="meta"), view, cfg)
        assert cache[0][0].shape[2:4] == (cfg.n_kv_heads, 16)
        tokens = torch.empty((rows, s), dtype=torch.int32, device="meta")
        pre, _, _ = dryrun.count_step(make_prefill(cfg), (
            params, {"tokens": tokens}, cache), False)
        step, _, _ = dryrun.count_step(make_decode(cfg), (
            params, tokens[:, :1], cache, s), False)
    got = {**step.per_collective, "total": step.collective_bytes}
    assert got == smoke._seq_decode_collectives(cfg, sizes, rows)
    tiles = smoke._seq_serve_launches(cfg, 1)
    k1 = tiles["fused_matmul_by_tile"]
    assert (pre.kernels["fused_matmul"]["calls"]
            + step.kernels["fused_matmul"]["calls"]) == sum(k1.values())
    assert step.kernels["fused_matmul"]["calls"] == k1["decode"] - 1
    assert pre.kernels["flash_attention"]["calls"] == sum(
        tiles["flash_attention_by_tile"].values()) == cfg.n_layers
    assert "flash_attention" not in step.kernels


def _rec_config(arch):
    """A reduced configuration of ``arch`` whose heads a model axis of 16
    divides where the family needs it (RWKV-6: 16 heads of 8)."""
    import dataclasses
    cfg = reg.get_config(arch, reduced=True)
    if arch == "rwkv6-7b":
        cfg = cfg.with_(n_heads=16, n_kv_heads=16, head_dim=8,
                        rwkv=dataclasses.replace(cfg.rwkv, head_size=8))
    return cfg


@pytest.mark.parametrize("sizes", [{"data": 1, "model": 4},
                                   {"data": 1, "model": 8},
                                   {"data": 2, "model": 2},
                                   {"data": 16, "model": 16}],
                         ids=lambda s: "x".join(map(str, s.values())))
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-7b",
                                  "whisper-tiny"])
def test_chip_smoke_reckons_the_rec_steps(arch, dtype, sizes):
    """``chip_smoke.py``'s reckonings of phase ``dist-rec`` (a decode
    step's collective bytes by kind; K5's and K6's launches of a prefill
    and decode steps) against the meta count of one rank's steps of the
    reduced configuration on a rank view; the card's count is held to the
    meta count there.  Griffin's 5 layers hold a (rec, rec, attn) triple
    and the unstacked tail, whose carry a data axis splits along its
    channels; Whisper's caches take the KV-head form on 2, the sequence
    form on 4 and 8 and, for the cross cache on 16, the whole form."""
    from repro_torch.serving.engine import make_decode, make_prefill
    smoke = _chip_smoke()
    cfg = _rec_config(arch)
    if dtype == "fp32":
        cfg = cfg.with_(dtype=torch.float32, kv_cache_dtype=torch.float32)
    rows, s, length = 2, 12, 16 * sizes["model"]
    view = rank_view(tuple(sizes.values()), tuple(sizes))
    mod = family_module(cfg)
    with logical.use_rules(view):
        params = sharding.shard_params(mod.init(cfg, None, "meta"), view,
                                       glu=cfg.mlp_glu)
        cache = sharding.shard_cache(mod.init_cache(
            cfg, rows * sizes["data"], length, device="meta"), view, cfg)
        batch = {k: x[:rows] for k, x in reg.input_specs(
            cfg, reg.ShapeSpec("t", s, rows, "prefill")).items()}
        pre, _, _ = dryrun.count_step(make_prefill(cfg), (
            params, batch, cache), False)
        step, _, _ = dryrun.count_step(make_decode(cfg), (
            params, batch["tokens"][:, :1], cache, s), False)
    got = {**step.per_collective, "total": step.collective_bytes}
    assert got == smoke._rec_decode_collectives(cfg, sizes, rows, length)
    want = smoke._rec_serve_launches(cfg)
    calls = {k: pre.kernels.get(k, {}).get("calls", 0)
             for k in ("rglru_scan", "rwkv6_wkv")}
    assert calls == {"rglru_scan": want.get("rglru_scan", 0),
                     "rwkv6_wkv": sum(want.get("rwkv6_scan_by_tile",
                                               {}).values())}
    assert not {"rglru_scan", "rwkv6_wkv"} & set(step.kernels)


def _j_rec_config(arch):
    """The reference's counterpart of ``_rec_config``."""
    import dataclasses
    cfg = j_get_config(arch, reduced=True)
    if arch == "rwkv6-7b":
        cfg = cfg.with_(n_heads=16, n_kv_heads=16, head_dim=8,
                        rwkv=dataclasses.replace(cfg.rwkv, head_size=8))
    return cfg


@pytest.fixture
def rec_pod_grid(pod_grid, monkeypatch):
    """``pod_grid`` with RWKV-6's reduced heads widened to 16 of 8, which
    a model axis of 16 divides."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch, **ov: _rec_config(arch).with_(**ov))


REC_POD_CELLS = [(arch, shape) for arch in ("recurrentgemma-2b", "rwkv6-7b",
                                            "whisper-tiny")
                 for shape in ("train_4k", "prefill_32k", "decode_32k",
                               "long_500k")
                 if reg.cell_applicable(arch, shape)]


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
@pytest.mark.parametrize("arch, shape", REC_POD_CELLS)
def test_pod_recurrent_and_whisper_cells_count_rank_zero(
        tmp_path, rec_pod_grid, arch, shape, mesh_name):
    """The 22 cells of the recurrent families and Whisper are ``ok`` on
    both pod meshes: the reference's per-chip fields, and argument bytes
    equal to rank 0's shards under the reference's own specs: a train
    cell's params in bf16 with master, mu and nu in fp32, the step and
    its batch rows; a serving cell's params and cache (placed by
    ``cache_shardings``: Griffin's ring split along the window, its
    tail's carry along the channels over the batch axes, RWKV-6's state
    by heads, Whisper's self cache along its positions and its cross
    cache whole) and its batch rows (long_500k's one row on every
    rank)."""
    r = dryrun.run_cell(arch, shape, mesh_name, out_dir=str(tmp_path))
    assert r["status"] == "ok", r.get("reason")
    sizes_names = dryrun.MESHES[mesh_name]
    sizes = dict(zip(sizes_names[1], sizes_names[0]))
    chips = math.prod(sizes.values())
    assert (r["chips"], r["mesh"]) == (chips, mesh_name)
    assert r["roofline"]["model_flops_per_chip"] == pytest.approx(
        r["model_flops_total"] / chips, rel=1e-12)
    jcfg, spec = _j_rec_config(arch), reg.SHAPES[shape]
    mesh = compat_abstract_mesh(*sizes_names)
    params = jax.eval_shape(lambda k: j_family(jcfg).init(jcfg, k),
                            jax.random.PRNGKey(0))
    sh = j_sharding.param_shardings(params, mesh)
    extra = 3 * 4 if spec.mode == "train" else 0
    want = sum(_local_bytes(x.shape, tuple(s_.spec), sizes,
                            x.dtype.itemsize + extra)
               for x, s_ in zip(jax.tree.leaves(params), jax.tree.leaves(sh)))
    batch_ranks = sizes["data"] * sizes.get("pod", 1)
    rows = (spec.global_batch // batch_ranks
            if spec.global_batch % batch_ranks == 0 else spec.global_batch)
    cfg = _rec_config(arch)
    audio = (rows * cfg.encdec.n_audio_ctx * cfg.d_model * 4
             if cfg.encdec is not None and spec.mode != "decode" else 0)
    if spec.mode == "train":
        want += 4 + 2 * rows * spec.seq_len * 4 + audio
    else:
        cache = jax.eval_shape(lambda: j_family(jcfg).init_cache(
            jcfg, spec.global_batch, spec.seq_len))
        csh = j_sharding.cache_shardings(cache, mesh, jcfg)
        want += sum(_local_bytes(x.shape, tuple(s_.spec), sizes,
                                 x.dtype.itemsize)
                    for x, s_ in zip(jax.tree.leaves(cache),
                                     jax.tree.leaves(csh)))
        want += rows * (spec.seq_len if spec.mode == "prefill" else 1) * 4
        want += audio
    assert r["memory"]["argument_bytes"] == want
    assert r["kernels"]["fused_matmul"]["calls"] > 0
    if spec.mode == "prefill":
        k = {"recurrentgemma-2b": "rglru_scan", "rwkv6-7b": "rwkv6_wkv",
             "whisper-tiny": "flash_attention"}[arch]
        assert r["kernels"][k]["calls"] > 0


def test_pod_rec_decode_cell_collectives_as_reckoned(tmp_path,
                                                     rec_pod_grid):
    """RWKV-6's decode_32k cell on ``single``, rank 0 (reduced, widened:
    d 128, 16 heads of 8, d_ff 256, vocab 512, 3 layers, bf16; 2 rows a
    rank), each head's state on its rank.

    * all-gather: a layer's weights over data (w_r, w_k, w_v, w_g, w_o
      and w_cm_r d x d/16 each, w_cm_k and w_cm_v d x d_ff/16), and the
      channel mix's receptance over model (2 x d); the embedding and the
      lm_head over data (vocab/16 x d each), the logits over model (2 x
      vocab, fp32).
    * all-reduce, fp32: a layer's two exits (2 x d); the embedding's sum
      (2 x d, bf16)."""
    r = dryrun.run_cell("rwkv6-7b", "decode_32k", "single",
                        out_dir=str(tmp_path))
    d, ff, v, n, rows, e = 128, 256, 512, 3, 2, 2
    layer = (6 * d * d + 2 * d * ff) // 16 * e + rows * d * e
    gather = n * layer + 2 * v // 16 * d * e + rows * v * 4
    reduce = n * 2 * rows * d * 4 + rows * d * e
    assert r["collective_bytes"] == {"all-gather": gather,
                                     "all-reduce": reduce,
                                     "total": gather + reduce}
