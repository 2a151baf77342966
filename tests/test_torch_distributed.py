"""The port's distribution against the reference's: the logical rules, the
parameter, batch and cache rules, and the multi-rank behaviours.

The rules run in process, the port's on abstract meshes and meta tensors,
the reference's on abstract meshes and ``jax.eval_shape`` trees, so full
widths cost no memory; specs must be equal (``==`` to ``tuple(P)``).

The multi-rank behaviours run in two subprocesses on the same numpy
inputs: the reference on 8 forced host devices (as
``tests/test_distributed.py`` runs it) and the port in a gloo world of 8
CPU ranks (``launch.mesh.run_world``, one thread a rank, the rendezvous a
file in the test's temporary directory).  Collective matmul (mesh (8,)),
MoE EP (reduced OLMoE, fp32, mesh (2, 4)) and the pipeline (mesh (4,))
are held to the reference's 1e-4; ``shard_map_gemm`` over 8 ranks and
``psum_compressed`` exactly; each rank's shards of a placed param tree
``==`` the reference's addressable shard at the same mesh coordinates;
a checkpoint restored onto a 2-rank mesh to its slices.  Each
subprocess has a timeout, and each rank's collectives one, so no world
can hang the suite.
"""

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
from repro.distributed import logical as j_logical        # noqa: E402
from repro.distributed import sharding as j_sharding      # noqa: E402
from repro.launch.mesh import compat_abstract_mesh        # noqa: E402
from repro.models.base import family_module as j_family   # noqa: E402
from repro.models.moe import moe_init as j_moe_init       # noqa: E402
from repro_torch.configs.registry import get_config       # noqa: E402
from repro_torch.core import tree                         # noqa: E402
from repro_torch.distributed import logical, sharding     # noqa: E402
from repro_torch.launch.mesh import abstract_mesh         # noqa: E402
from repro_torch.models import moe                        # noqa: E402
from repro_torch.models.base import family_module         # noqa: E402
from repro_torch.models.convert import to_torch           # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
MESHES = [((16,), ("model",)), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")), ((1, 1), ("data", "model")),
          ((2, 4), ("data", "model"))]
SHAPES = [((7,), ("heads",)), ((32,), ("heads",)),
          ((8, 4), ("batch", None)), ((64, 4096), ("batch", "embed")),
          ((4096, 64000), ("embed", "vocab")),
          ((32, 64, 2048, 1024), (None, "experts", "embed", "mlp_expert")),
          ((3, 5), ("mlp", "heads")), ((16, 16), ("heads", "kv_heads")),
          ((6, 8), ("batch", "seq_shard"))]
WORLD_TIMEOUT = 300          # seconds, each subprocess


def _ids(case):
    return "x".join(map(str, case[0]))


def _j_tree(arch, mesh_case, kind):
    """The reference's spec tree of ``arch`` at full width on an abstract
    mesh, with its paths: (param | mu | cache)."""
    cfg = j_get_config(arch)
    mod = j_family(cfg)
    mesh = compat_abstract_mesh(*mesh_case)
    if kind == "cache":
        cache = jax.eval_shape(lambda: mod.init_cache(cfg, 32, 1024))
        sh = j_sharding.cache_shardings(cache, mesh, cfg)
    else:
        sh = j_sharding.param_shardings(jax.eval_shape(
            lambda k: mod.init(cfg, k), jax.random.PRNGKey(0)), mesh)
    flat = jax.tree_util.tree_flatten_with_path(sh)[0]
    return [tuple(s.spec) for _, s in flat]


def _meta_params(arch):
    cfg = get_config(arch)
    return cfg, family_module(cfg).init(cfg, torch.Generator(), "meta")


# ---------------------------------------------------------------------------
# The rules, in process.
# ---------------------------------------------------------------------------

class TestLogicalRules:
    def test_inactive_is_identity(self):
        x = torch.ones(4, 4)
        assert logical.constrain(x, ("batch", "embed")) is x
        assert logical.spec_for((4, 4), ("batch", "embed")) is None

    @pytest.mark.parametrize("mesh_case", MESHES, ids=_ids)
    @pytest.mark.parametrize("rules", [None, {"heads": None},
                                       {"batch": "data", "seq": "model"}],
                             ids=["default", "no-heads", "custom"])
    def test_spec_for_matches_reference(self, mesh_case, rules):
        """Divisible, indivisible, missing-axis and already-used axes,
        entry for entry the reference's."""
        j_mesh = compat_abstract_mesh(*mesh_case)
        mesh = abstract_mesh(*mesh_case)
        for shape, axes in SHAPES:
            with j_logical.use_rules(j_mesh, rules):
                ref = tuple(j_logical.spec_for(shape, axes))
            with logical.use_rules(mesh, rules):
                assert logical.spec_for(shape, axes) == ref, (shape, axes)

    def test_divisibility_fallback(self):
        mesh = abstract_mesh((16,), ("model",))
        with logical.use_rules(mesh, {"heads": "model"}):
            assert logical.spec_for((7,), ("heads",)) == (None,)
            assert logical.spec_for((32,), ("heads",)) == ("model",)

    def test_missing_axis_partial_tuple(self):
        mesh = abstract_mesh((1,), ("data",))
        with logical.use_rules(mesh, {"batch": ("pod", "data")}):
            assert logical.spec_for((8, 4), ("batch", None))[0] == "data"

    def test_placements(self):
        from torch.distributed.tensor import Replicate, Shard
        mesh = abstract_mesh((2, 4, 8), ("pod", "data", "model"))
        s = logical.NamedSharding(mesh, (("pod", "data"), None, "model"))
        assert s.placements == (Shard(0), Shard(0), Shard(2))
        assert logical.NamedSharding(mesh, ()).placements == (Replicate(),) * 3
        with pytest.raises(NotImplementedError):
            logical.NamedSharding(mesh, (("data", "pod"),)).placements


class TestParamShardings:
    @pytest.mark.parametrize("mesh_case", MESHES[1:], ids=_ids)
    @pytest.mark.parametrize("arch", ["yi-6b", "olmoe-1b-7b", "gemma2-2b",
                                      "whisper-tiny"])
    def test_specs_match_reference(self, arch, mesh_case):
        """Full-width param trees, leaf by leaf in JAX's order."""
        _, params = _meta_params(arch)
        mesh = abstract_mesh(*mesh_case)
        sh = tree.leaves(sharding.param_shardings(params, mesh))
        assert all(s.mesh is mesh for s in sh)
        assert [s.spec for s in sh] == _j_tree(arch, mesh_case, "param")

    def test_opt_state_mirrors_params(self):
        """mu/nu leaves inherit the same name-based rules."""
        from repro_torch.optim import adamw
        _, params = _meta_params("whisper-tiny")
        opt = adamw.init(adamw.AdamWConfig(), params)
        mesh = abstract_mesh((2, 4), ("data", "model"))
        ps = tree.leaves(sharding.param_shardings(params, mesh))
        for key in ("mu", "nu"):
            ms = tree.leaves(sharding.param_shardings(opt[key], mesh))
            assert [s.spec for s in ps] == [s.spec for s in ms]

    def test_no_mesh_gives_none(self):
        _, params = _meta_params("yi-6b")
        sh = sharding.param_shardings(params, None)
        assert tree.flatten_with_path(sh) == []

    def test_expert_parallel_rules_shard_only_the_experts(self):
        _, params = _meta_params("olmoe-1b-7b")
        mesh = abstract_mesh((1, 2), ("data", "model"))
        sh = sharding.param_shardings(params, mesh,
                                      sharding.EXPERT_PARALLEL_RULES)
        for path, s in tree.flatten_with_path(sh):
            if path[-1] in ("experts_wi", "experts_wo"):
                assert s.spec == (None, "model", None, None), path
            else:
                assert all(e is None for e in s.spec), path


class TestMoeMeshRules:
    """``moe_apply`` under meshes without ranks, in process."""

    def _case(self):
        cfg = get_config("olmoe-1b-7b", reduced=True).with_(
            dtype=torch.float32)
        p = moe.moe_init(cfg, torch.Generator().manual_seed(0))
        x = torch.randn(2, 3, cfg.d_model,
                        generator=torch.Generator().manual_seed(1))
        return cfg, p, x

    def test_gspmd_expert_parallelism_refused(self):
        """``moe_shard_map=False`` under a model axis of 2 is not refused:
        the ranks' partials in turn (``tests/test_torch_gspmd_ep.py``
        holds them against the reference) equal all experts at once
        within fp32 rounding; a model axis of 1 is the single-device math
        either way."""
        cfg, p, x = self._case()
        gspmd = cfg.with_(moe_shard_map=False)
        whole = moe.moe_apply(gspmd, p, x)
        mesh = abstract_mesh((1, 2), ("data", "model"))
        got = moe.moe_apply(gspmd, p, x, mesh=mesh)
        assert (got - whole).abs().max() <= 1e-5 * whole.abs().max()
        one = abstract_mesh((2, 1), ("data", "model"))
        assert torch.equal(moe.moe_apply(gspmd, p, x, mesh=one), whole)

    def test_expert_shard_needs_its_mesh(self):
        cfg, p, x = self._case()
        half = dict(p, experts_wi=p["experts_wi"][:2],
                    experts_wo=p["experts_wo"][:2])
        with pytest.raises(ValueError, match="experts where"):
            moe.moe_apply(cfg, half, x)
        with pytest.raises(ValueError, match="experts where"):
            moe.moe_apply(cfg, half, x,
                          mesh=abstract_mesh((1, 2), ("data", "model")))


class TestBatchCacheShardings:
    @pytest.mark.parametrize("mesh_case", MESHES[1:], ids=_ids)
    @pytest.mark.parametrize("arch", ["yi-6b", "gemma2-2b", "deepseek-67b"])
    def test_cache_specs_match_reference(self, arch, mesh_case):
        cfg = get_config(arch)
        cache = family_module(cfg).init_cache(cfg, 32, 1024, device="meta")
        sh = sharding.cache_shardings(cache, abstract_mesh(*mesh_case), cfg)
        assert [s.spec for s in tree.leaves(sh)] == _j_tree(arch, mesh_case,
                                                            "cache")

    def test_deepseek_kv_heads_fall_back_to_the_sequence(self):
        """8 KV heads do not divide a 16-way model axis: the cache's
        sequence dim takes it."""
        cfg = get_config("deepseek-67b")
        cache = family_module(cfg).init_cache(cfg, 32, 1024, device="meta")
        mesh = abstract_mesh((16, 16), ("data", "model"))
        for s in tree.leaves(sharding.cache_shardings(cache, mesh, cfg)):
            assert s.spec == (None, "data", None, "model", None)

    @pytest.mark.parametrize("mesh_case", MESHES, ids=_ids)
    def test_batch_specs_match_reference(self, mesh_case):
        batch = {"tokens": torch.empty(32, 128, device="meta"),
                 "audio": torch.empty(6, 1500, 384, device="meta")}
        j_batch = {"tokens": jax.ShapeDtypeStruct((32, 128), jnp.int32),
                   "audio": jax.ShapeDtypeStruct((6, 1500, 384), jnp.float32)}
        ref = j_sharding.batch_shardings(
            j_batch, compat_abstract_mesh(*mesh_case))
        sh = sharding.batch_shardings(batch, abstract_mesh(*mesh_case))
        assert ([s.spec for s in tree.leaves(sh)]
                == [tuple(s.spec) for s in jax.tree.leaves(ref)])


# ---------------------------------------------------------------------------
# Multi-rank: the reference on 8 host devices, the port on 8 gloo ranks.
# ---------------------------------------------------------------------------

MOE_B, MOE_S = 4, 16

_REFERENCE_PROG = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys
    sys.path.insert(0, sys.argv[1])
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.core.jaxcompat import shard_map
    from repro.launch.mesh import compat_make_mesh

    inp = dict(np.load(os.path.join(sys.argv[2], "inputs.npz")))
    out = {}

    from repro.distributed.collective_matmul import collective_matmul
    mesh8 = compat_make_mesh((8,), ("model",))
    from repro.launch.mesh import make_host_mesh
    out["host_mesh"] = np.array(make_host_mesh(model=4).devices.shape)
    out["cmm"] = collective_matmul(jnp.asarray(inp["cmm_x"]),
                                   jnp.asarray(inp["cmm_w"]), mesh8)
    out["cmm_int"] = collective_matmul(
        jnp.asarray(inp["cmm_xi"]).astype(jnp.int32),
        jnp.asarray(inp["cmm_wi"]).astype(jnp.int32), mesh8)

    from repro.configs.registry import get_config
    from repro.models.moe import moe_apply
    cfg = get_config("olmoe-1b-7b", reduced=True).with_(dtype=jnp.float32)
    p = {k[4:]: jnp.asarray(v) for k, v in inp.items()
         if k.startswith("moe/")}
    out["moe"] = moe_apply(cfg, p, jnp.asarray(inp["moe_x"]),
                           mesh=compat_make_mesh((2, 4), ("data", "model")))

    from repro.distributed.pipeline import pipeline_apply
    def block_fn(stage_params, x):
        def body(c, w):
            return jnp.tanh(c @ w), None
        return jax.lax.scan(body, x, stage_params)[0]
    out["pipe"] = pipeline_apply(block_fn, jnp.asarray(inp["pipe_w"]),
                                 jnp.asarray(inp["pipe_x"]),
                                 compat_make_mesh((4,), ("pp",)), axis="pp")

    from repro.distributed.sharding import shard_map_gemm
    for dim in ("m", "n"):
        out[f"gemm_{dim}"] = shard_map_gemm(jnp.asarray(inp["gemm_a"]),
                                            jnp.asarray(inp["gemm_b"]), 8,
                                            dim=dim)

    from repro.optim.compression import psum_compressed
    def psum(g1, g2, r1, r2):
        avg, res = psum_compressed({"a": g1[0], "b": g2[0]},
                                   {"a": r1[0], "b": r2[0]}, "model")
        return (avg["a"][None], avg["b"][None], res["a"][None],
                res["b"][None])
    got = shard_map(psum, mesh=mesh8, in_specs=(P("model"),) * 4,
                    out_specs=(P("model"),) * 4, check_vma=False)(
        *(jnp.asarray(inp[k]) for k in ("g_a", "g_b", "r_a", "r_b")))
    for k, v in zip(("avg_a", "avg_b", "res_a", "res_b"), got):
        out[k] = v

    from repro.distributed.sharding import param_shardings
    from repro.models.base import family_module
    mod = family_module(cfg)
    like = jax.eval_shape(lambda k: mod.init(cfg, k), jax.random.PRNGKey(0))
    names = [k for k in inp if k.startswith("param/")]
    leaves = [jnp.asarray(inp[k]) for k in names]
    params = jax.tree.unflatten(jax.tree.structure(like), leaves)
    mesh24 = compat_make_mesh((2, 4), ("data", "model"))
    for name, x, s in zip(names, leaves, jax.tree.leaves(
            param_shardings(params, mesh24))):
        placed = jax.device_put(x, s)
        for shard in placed.addressable_shards:
            c = np.argwhere(mesh24.devices == shard.device)[0]
            out[f"{name}@{c[0]}{c[1]}"] = np.asarray(shard.data)

    np.savez(os.path.join(sys.argv[2], "reference.npz"),
             **{k: np.asarray(v) for k, v in out.items()})
""")

_PORT_PROG = textwrap.dedent("""
    import os
    import sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch

    from repro_torch.launch.mesh import run_world


    def rank_main(world, tmp):
        torch.set_num_threads(1)
        from repro_torch.configs.registry import get_config
        from repro_torch.core import tree
        from repro_torch.distributed import collectives, sharding
        from repro_torch.distributed.collective_matmul import (
            collective_matmul)
        from repro_torch.distributed.pipeline import pipeline_apply
        from repro_torch.launch.mesh import (make_host_mesh, make_mesh,
                                             make_production_mesh)
        from repro_torch.models.base import family_module
        from repro_torch.models.moe import moe_apply
        from repro_torch.optim.compression import psum_compressed
        from repro_torch.runtime.checkpoint import CheckpointManager
        from repro_torch.core.fusion import linear

        r = world.rank
        inp = {k: torch.from_numpy(v) for k, v in
               np.load(os.path.join(tmp, "inputs.npz")).items()}
        out = {}

        host = make_host_mesh(model=4)
        out["host_mesh"] = np.array(list(host.shape.values())
                                    + list(host.coordinate))
        try:
            make_production_mesh()
            out["production_refused"] = np.array(False)
        except ValueError:
            out["production_refused"] = np.array(True)

        mesh8 = make_mesh((8,), ("model",))
        calls = {"exchange": 0, "all_gather": 0}
        inner = {k: getattr(collectives, k) for k in calls}
        def counted(name):
            def fn(*a, **kw):
                calls[name] += 1
                return inner[name](*a, **kw)
            return fn
        for k in calls:
            setattr(collectives, k, counted(k))
        y = collective_matmul(inp["cmm_x"], inp["cmm_w"], mesh8)
        for k in calls:
            setattr(collectives, k, inner[k])
        out["cmm_calls"] = np.array([calls["exchange"],
                                     calls["all_gather"]])
        out["cmm"] = collectives.all_gather(y.to_local(), dim=1)
        yi = collective_matmul(inp["cmm_xi"], inp["cmm_wi"], mesh8)
        out["cmm_int"] = collectives.all_gather(yi.to_local(), dim=1)

        cfg = get_config("olmoe-1b-7b", reduced=True).with_(
            dtype=torch.float32)
        p = {k[4:]: v for k, v in inp.items() if k.startswith("moe/")}

        def experts_placed(p, mesh):
            return sharding.local_shards(sharding.apply_shardings(
                p, sharding.param_shardings(
                    p, mesh, sharding.EXPERT_PARALLEL_RULES)))
        mesh_ep = make_mesh((2, 4), ("data", "model"))
        p_ep = experts_placed(p, mesh_ep)
        out["moe_experts_held"] = np.array(p_ep["experts_wi"].shape[0])
        out["moe"] = moe_apply(cfg, p_ep, inp["moe_x"], mesh=mesh_ep)
        # bf16 on the first two ranks, (data 1, model 2)
        mesh_12 = make_mesh((1, 2), ("data", "model"))
        if mesh_12.coordinate is not None:
            p16 = {k: v if k == "w_router" else v.to(torch.bfloat16)
                   for k, v in p.items()}
            out["moe_bf16"] = moe_apply(
                cfg.with_(dtype=torch.bfloat16),
                experts_placed(p16, mesh_12),
                inp["moe_x"].to(torch.bfloat16), mesh=mesh_12).float()

        mesh_pp = make_mesh((4,), ("pp",))
        if mesh_pp.coordinate is not None:
            def block_fn(stage_params, x):
                for w in stage_params:
                    x = linear(x, w, activation="tanh")
                return x
            out["pipe"] = pipeline_apply(block_fn, inp["pipe_w"],
                                         inp["pipe_x"], mesh_pp)

        for dim in ("m", "n"):
            out[f"gemm_{dim}"] = sharding.shard_map_gemm(
                inp["gemm_a"], inp["gemm_b"], 8, dim=dim)

        avg, res = psum_compressed({"a": inp["g_a"][r], "b": inp["g_b"][r]},
                                   {"a": inp["r_a"][r], "b": inp["r_b"][r]})
        out.update(avg_a=avg["a"], avg_b=avg["b"], res_a=res["a"],
                   res_b=res["b"])

        mod = family_module(cfg)
        like = mod.init(cfg, torch.Generator(), "meta")
        names = [k for k in inp if k.startswith("param/")]
        params = tree.unflatten(like, [inp[k] for k in names])
        mesh24 = make_mesh((2, 4), ("data", "model"))
        placed = sharding.local_shards(sharding.apply_shardings(
            params, sharding.param_shardings(params, mesh24)))
        c = mesh24.coordinate
        for name, x in zip(names, tree.leaves(placed)):
            out[f"{name}@{c[0]}{c[1]}"] = x

        mesh2 = make_mesh((2,), ("data",))
        if mesh2.coordinate is not None:
            from repro_torch.distributed.logical import NamedSharding
            like = {"w": torch.zeros(4, 4)}
            got, _ = CheckpointManager(os.path.join(tmp, "ckpt")).restore(
                1, like, shardings={"w": NamedSharding(mesh2,
                                                       ("data", None))})
            out["restored_local"] = got["w"].to_local()
            out["restored_full"] = collectives.all_gather(
                got["w"].to_local(), mesh2.group("data"))

        np.savez(os.path.join(tmp, f"rank{r}.npz"),
                 **{k: np.asarray(v) for k, v in out.items()})


    if __name__ == "__main__":
        run_world(rank_main, 8, (sys.argv[2],), device="cpu",
                  rendezvous=os.path.join(sys.argv[2], "rendezvous"),
                  timeout=float(sys.argv[3]))
""")


def _inputs(tmp):
    """Seeded numpy inputs of every multi-rank case, and the reference's
    (converted) reduced OLMoE params; saved for both worlds."""
    rng = np.random.default_rng(0)
    inp = {
        "cmm_x": rng.standard_normal((64, 32), dtype=np.float32),
        "cmm_w": rng.standard_normal((32, 64), dtype=np.float32),
        "cmm_xi": rng.integers(-8, 8, (64, 32)).astype(np.int8),
        "cmm_wi": rng.integers(-8, 8, (32, 64)).astype(np.int8),
        "moe_x": rng.standard_normal((MOE_B, MOE_S, 64), dtype=np.float32),
        "pipe_w": (rng.standard_normal((8, 16, 16), dtype=np.float32)
                   / np.float32(4.0)),
        "pipe_x": rng.standard_normal((6, 4, 16), dtype=np.float32),
        "gemm_a": rng.integers(-8, 8, (128, 96)).astype(np.int8),
        "gemm_b": rng.integers(-8, 8, (96, 64)).astype(np.int8),
        "g_a": rng.standard_normal((8, 5, 7), dtype=np.float32),
        "g_b": rng.standard_normal((8, 33), dtype=np.float32) * 3,
        "r_a": rng.standard_normal((8, 5, 7), dtype=np.float32) * 0.01,
        "r_b": rng.standard_normal((8, 33), dtype=np.float32) * 0.01,
    }
    cfg = j_get_config("olmoe-1b-7b", reduced=True).with_(dtype=jnp.float32)
    inp.update({f"moe/{k}": np.asarray(v) for k, v in
                j_moe_init(cfg, jax.random.PRNGKey(0)).items()})
    params = j_family(cfg).init(cfg, jax.random.PRNGKey(1))
    for i, leaf in enumerate(jax.tree.leaves(params)):
        inp[f"param/{i:03d}"] = np.asarray(leaf)
    np.savez(os.path.join(tmp, "inputs.npz"), **inp)
    return inp


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """(inputs, the reference's results, each port rank's results)."""
    from repro_torch.runtime.checkpoint import CheckpointManager
    tmp = str(tmp_path_factory.mktemp("worlds"))
    inp = _inputs(tmp)
    CheckpointManager(os.path.join(tmp, "ckpt")).save(
        1, {"w": torch.arange(16.0).reshape(4, 4)})
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


class TestMultiRank:
    def test_host_and_production_meshes(self, worlds):
        """make_host_mesh(model=4) over 8 ranks is the reference's (2, 4),
        row-major over the ranks; the production mesh needs 256 ranks."""
        _, ref, ranks = worlds
        for r, out in enumerate(ranks):
            assert out["host_mesh"].tolist() == [*ref["host_mesh"], r // 4,
                                                 r % 4]
            assert out["production_refused"]

    def test_collective_matmul_correct(self, worlds):
        inp, ref, ranks = worlds
        plain = inp["cmm_x"] @ inp["cmm_w"]
        for out in ranks:
            assert np.abs(out["cmm"] - ref["cmm"]).max() < 1e-4
            assert np.abs(out["cmm"] - plain).max() < 1e-4

    def test_collective_matmul_ring_form(self, worlds):
        """The point of the pattern: n - 1 passes of the held shard, no
        all-gather of X."""
        for out in worlds[2]:
            assert out["cmm_calls"].tolist() == [7, 0]

    def test_collective_matmul_int8_exact(self, worlds):
        _, ref, ranks = worlds
        for out in ranks:
            assert out["cmm_int"].dtype == np.int32
            assert np.array_equal(out["cmm_int"], ref["cmm_int"])

    def test_moe_ep_matches_reference(self, worlds):
        """Each rank's whole output (gathered over data) against the
        reference's sharded MoE and the port's single-rank MoE."""
        inp, ref, ranks = worlds
        cfg = get_config("olmoe-1b-7b", reduced=True).with_(
            dtype=torch.float32)
        p = {k[4:]: to_torch(v) for k, v in inp.items()
             if k.startswith("moe/")}
        # the reference's rule: capacity from each data slice's tokens
        x = to_torch(inp["moe_x"])
        cap = moe.moe_capacity(cfg, MOE_B // 2 * MOE_S)
        single = moe.moe_apply_local(
            cfg, x.reshape(-1, cfg.d_model), p["w_router"], p["experts_wi"],
            p["experts_wo"], 0, cap).reshape(x.shape).numpy()
        scale = np.abs(ref["moe"]).max()
        for out in ranks:
            assert out["moe"].shape == (MOE_B, MOE_S, 64)
            assert np.abs(out["moe"] - ref["moe"]).max() / scale < 1e-4
            assert np.abs(out["moe"] - single).max() / scale < 1e-4

    def test_moe_ep_ranks_hold_their_experts(self, worlds):
        """The expert leaves placed by ``EXPERT_PARALLEL_RULES``: 2 of the
        8 experts on each rank of the 4-way model axis."""
        _, _, ranks = worlds
        n = get_config("olmoe-1b-7b", reduced=True).moe.n_experts
        assert all(int(out["moe_experts_held"]) == n // 4 for out in ranks)

    def test_moe_ep_abstract_mesh_matches_reference(self, worlds):
        """The one-process form of EP (an abstract (2, 4) mesh, whole
        leaves) against the reference's sharded MoE."""
        inp, ref, _ = worlds
        cfg = get_config("olmoe-1b-7b", reduced=True).with_(
            dtype=torch.float32)
        p = {k[4:]: to_torch(v) for k, v in inp.items()
             if k.startswith("moe/")}
        got = moe.moe_apply(cfg, p, to_torch(inp["moe_x"]),
                            mesh=abstract_mesh((2, 4), ("data", "model")))
        scale = np.abs(ref["moe"]).max()
        assert np.abs(got.numpy() - ref["moe"]).max() / scale < 1e-4

    def test_moe_ep_bf16_two_ranks_equal_one_process(self, worlds):
        """bf16 EP over two ranks is the one-process form on an abstract
        (1, 2) mesh bit for bit: each rank's partial, one rounding of
        their sum."""
        inp, _, ranks = worlds
        cfg = get_config("olmoe-1b-7b", reduced=True).with_(
            dtype=torch.bfloat16)
        p = {k[4:]: to_torch(v) for k, v in inp.items()
             if k.startswith("moe/")}
        p = {k: v if k == "w_router" else v.to(torch.bfloat16)
             for k, v in p.items()}
        x = to_torch(inp["moe_x"]).to(torch.bfloat16)
        one = moe.moe_apply(cfg, p, x, mesh=abstract_mesh(
            (1, 2), ("data", "model"))).float().numpy()
        whole = moe.moe_apply(cfg, p, x).float().numpy()
        for out in ranks[:2]:
            assert np.array_equal(out["moe_bf16"], one)
            assert np.abs(out["moe_bf16"] - whole).max() < (
                2e-2 * np.abs(whole).max())
        assert all("moe_bf16" not in out for out in ranks[2:])

    def test_pipeline_matches_reference(self, worlds):
        inp, ref, ranks = worlds
        seq = inp["pipe_x"]
        for w in inp["pipe_w"]:
            seq = np.tanh(seq @ w)
        for out in ranks[:4]:
            assert np.abs(out["pipe"] - ref["pipe"]).max() < 1e-4
            assert np.abs(out["pipe"] - seq).max() < 1e-4
        assert all("pipe" not in out for out in ranks[4:])

    @pytest.mark.parametrize("dim", ["m", "n"])
    def test_shard_map_gemm_over_ranks_exact(self, worlds, dim):
        _, ref, ranks = worlds
        for out in ranks:
            assert out[f"gemm_{dim}"].dtype == np.int32
            assert np.array_equal(out[f"gemm_{dim}"], ref[f"gemm_{dim}"])

    def test_psum_compressed_exact(self, worlds):
        _, ref, ranks = worlds
        for r, out in enumerate(ranks):
            for k in ("avg_a", "avg_b", "res_a", "res_b"):
                assert np.array_equal(out[k], ref[k][r]), (r, k)

    def test_local_shards_equal_reference(self, worlds):
        _, ref, ranks = worlds
        keys = [k for k in ref if k.startswith("param/")]
        assert len(keys) == 8 * len({k.split("@")[0] for k in keys})
        for out in ranks:
            mine = [k for k in out if k.startswith("param/")]
            assert len(mine) == len(keys) // 8
            for k in mine:
                assert out[k].shape == ref[k].shape, k
                assert np.array_equal(out[k], ref[k]), k

    def test_elastic_restore_onto_two_ranks(self, worlds, tmp_path):
        """A checkpoint saved whole restores onto a 2-rank mesh: each
        rank holds its rows, and the whole equals the reference's restore
        of the same checkpoint (``tests/test_runtime.py``'s case)."""
        from jax.sharding import NamedSharding, PartitionSpec as P
        from repro.launch.mesh import compat_make_mesh
        from repro.runtime.checkpoint import CheckpointManager as JManager
        from repro_torch.runtime.checkpoint import CheckpointManager
        whole = torch.arange(16.0).reshape(4, 4)
        CheckpointManager(str(tmp_path)).save(1, {"w": whole})
        mesh = compat_make_mesh((1,), ("data",))
        j_like = {"w": jnp.zeros((4, 4), jnp.float32)}
        sh = {"w": NamedSharding(mesh, P("data", None))}
        j_got, _ = JManager(str(tmp_path)).restore(1, j_like, shardings=sh)
        for r, out in enumerate(worlds[2][:2]):
            assert np.array_equal(out["restored_local"],
                                  whole[2 * r:2 * r + 2].numpy())
            assert np.array_equal(out["restored_full"],
                                  np.asarray(j_got["w"]))
        assert all("restored_local" not in out for out in worlds[2][2:])
