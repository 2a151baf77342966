"""GSPMD expert parallelism: ``moe_shard_map=False`` under a mesh, the
reference's ``else`` branch of ``moe_apply``, against the reference.

The reference routes the whole batch at its capacity and lets GSPMD
partition the work wherever the rules put the expert leaves; perf_iter's
``ar_gspmd_ep`` puts the experts over ``data`` and each expert's d_ff over
``model``.  The port keeps the leaves as the rank's shards, gathers the
tokens over the batch axes and sums the ranks' fp32 partials
(``models/moe.py::_moe_gspmd``); on an abstract mesh one process runs
every rank's partial in turn (``_moe_gspmd_in_turn``).

In process: reduced OLMoE and Arctic under those rules on an abstract
(data 2, model 2) mesh against the reference's ``moe_apply`` off the
mesh (within 1e-5 of max |y| in fp32), with a capacity factor at which
tokens overflow, where the per-slice capacity of the ``shard_map`` form
gives another answer; the default rules' form on a model axis of 2; a
model axis of 1; training through the ranks in turn; the ``shard_map``
form's refusal of the experts over every rank (the GSPMD form takes
them: ``tests/test_torch_gspmd_train.py``); the paired GLU shards of
``experts_wi``;
``chip_smoke.py``'s reckonings of a decode step's collective bytes and of
the launches, against the meta count on rank views.

In a gloo world of 4 CPU ranks (``launch.mesh.run_world``) on (data 2,
model 2), reduced OLMoE (capacity factor 0.5: tokens overflow) serving 4
prompts, a prefill and 2 decode steps: under the rules as they are, each
rank's logits (its 2 rows) within 1e-5 of the reference's served off the
mesh, greedy identical; under the same expert placement with the dense
leaves whole (``chip_smoke.GSPMD_WHOLE_RULES``), in fp32 and bf16, bit
for bit the port's one process running the ranks' partials in turn;
``shard_params`` / ``gather_params`` round trip the expert leaves; and
``moe_apply(..., mesh=)`` on each rank, under ``EXPERT_PARALLEL_RULES``
and under ar_gspmd_ep's rules, against the reference's block.
"""

import dataclasses
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.models.moe as j_moe                              # noqa: E402
from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.models.base import family_module as j_family       # noqa: E402
from repro_torch import NotPorted                             # noqa: E402
from repro_torch.configs.registry import get_config           # noqa: E402
from repro_torch.core import tree                             # noqa: E402
from repro_torch.distributed import logical, sharding         # noqa: E402
from repro_torch.launch import dryrun                         # noqa: E402
from repro_torch.launch.mesh import abstract_mesh, rank_view  # noqa: E402
from repro_torch.models import moe                            # noqa: E402
from repro_torch.models.base import family_module             # noqa: E402
from repro_torch.models.convert import params_from_jax        # noqa: E402
from repro_torch.serving.engine import make_decode, make_prefill  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD_TIMEOUT = 300          # seconds
#: perf_iter's ar_gspmd_ep rules
RULES = {"experts": "data", "mlp_expert": "model", "embed": None}
B, S, STEPS, CAP = 4, 12, 2, 0.5


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _with_capacity(cfg, factor):
    return cfg.with_(moe=dataclasses.replace(cfg.moe,
                                             capacity_factor=factor))


def _moe_case(arch, factor):
    """(reference cfg, port cfg, reference params, port params, x) of one
    MoE block in fp32, ``moe_shard_map=False``."""
    jcfg = _with_capacity(j_get_config(arch, reduced=True).with_(
        dtype=jnp.float32, moe_shard_map=False), factor)
    tcfg = _with_capacity(get_config(arch, reduced=True).with_(
        dtype=torch.float32, moe_shard_map=False), factor)
    jp = j_moe.moe_init(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    x = np.random.default_rng(1).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _dropped(cfg, p, x):
    """Routed (token, expert) pairs past the whole batch's capacity."""
    _, idx = moe.route(cfg, x.reshape(-1, cfg.d_model), p["w_router"])
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.moe.n_experts)
    cap = moe.moe_capacity(cfg, x.shape[0] * x.shape[1])
    return int(torch.clamp(counts - cap, min=0).sum())


class TestInProcess:
    @pytest.mark.parametrize("factor", [4.0, CAP])
    @pytest.mark.parametrize("arch", ["olmoe-1b-7b", "arctic-480b"])
    def test_ranks_in_turn_match_reference_off_mesh(self, arch, factor):
        """The ranks' partials in turn on an abstract (data 2, model 2)
        mesh under ar_gspmd_ep's rules equal the reference's global
        ``moe_apply``; at factor 0.5 tokens overflow, and the per-slice
        capacity of the ``shard_map`` form gives another answer."""
        jcfg, tcfg, jp, tp, x = _moe_case(arch, factor)
        ref = np.asarray(j_moe.moe_apply(jcfg, jp, jnp.asarray(x)))
        mesh = abstract_mesh((2, 2), ("data", "model"))
        calls = []
        inner = moe._moe_gspmd_in_turn
        try:
            moe._moe_gspmd_in_turn = lambda *a: calls.append(1) or inner(*a)
            with logical.use_rules(mesh, RULES):
                got = moe.moe_apply(tcfg, tp, torch.from_numpy(x))
        finally:
            moe._moe_gspmd_in_turn = inner
        assert calls and got.shape == x.shape
        assert _rel(got, ref) <= 1e-5
        xt = torch.from_numpy(x)
        if factor == CAP:
            assert _dropped(tcfg, tp, xt) > 0
            sliced = moe.moe_apply(tcfg.with_(moe_shard_map=True), tp, xt,
                                   mesh=mesh)
            assert _rel(sliced, ref) > 1e-2
        else:
            assert _dropped(tcfg, tp, xt) == 0

    def test_default_rules_form_on_model_2(self):
        """Under the default rules the experts lie over ``model``; the
        same code runs the model ranks' partials in turn."""
        jcfg, tcfg, jp, tp, x = _moe_case("olmoe-1b-7b", CAP)
        ref = np.asarray(j_moe.moe_apply(jcfg, jp, jnp.asarray(x)))
        mesh = abstract_mesh((1, 2), ("data", "model"))
        assert moe._gspmd_axes(tcfg, mesh)[:2] == (("model",), ())
        got = moe.moe_apply(tcfg, tp, torch.from_numpy(x), mesh=mesh)
        assert _rel(got, ref) <= 1e-5

    def test_model_axis_of_one_is_the_global_function(self):
        jcfg, tcfg, jp, tp, x = _moe_case("olmoe-1b-7b", CAP)
        ref = np.asarray(j_moe.moe_apply(jcfg, jp, jnp.asarray(x)))
        one = abstract_mesh((2, 1), ("data", "model"))
        assert moe._gspmd_axes(tcfg, one)[:2] == ((), ())
        got = moe.moe_apply(tcfg, tp, torch.from_numpy(x), mesh=one)
        assert _rel(got, ref) <= 1e-5

    def test_training_through_the_gspmd_form_runs(self):
        """Under autograd (the plain torch route, as every MoE train step)
        the ranks' partials in turn on an abstract (data 2, model 2) mesh
        under ar_gspmd_ep's rules give the gradients of the block off the
        mesh (x, the router and both expert leaves within 1e-5 of their
        max)."""
        _, tcfg, _, tp, x = _moe_case("olmoe-1b-7b", CAP)
        tcfg = tcfg.with_(backend="torch")       # K4 has no backward
        probe = torch.from_numpy(np.random.default_rng(2).standard_normal(
            x.shape).astype(np.float32))
        grads = {}
        for run, mesh in (("off", None),
                          ("in_turn", abstract_mesh((2, 2), ("data",
                                                             "model")))):
            p = {k: v.clone().requires_grad_() for k, v in tp.items()}
            xt = torch.from_numpy(x).requires_grad_()
            with logical.use_rules(mesh, RULES):
                y = moe.moe_apply(tcfg, p, xt)
            (y * probe).sum().backward()
            grads[run] = {"x": xt.grad, **{k: v.grad for k, v in p.items()}}
        for k, g in grads["off"].items():
            assert _rel(grads["in_turn"][k], g) <= 1e-5, k

    def test_refusals(self):
        """The ``shard_map`` form with a dim split over ``model`` and
        another axis (the experts over every rank, which the reference
        reshards to ``P("model")`` there) raises ``NotPorted`` naming item
        7c on a rank; the GSPMD form takes it."""
        _, tcfg, _, _, _ = _moe_case("olmoe-1b-7b", CAP)
        rules = {"experts": ("data", "model")}
        view = rank_view((2, 2), ("data", "model"), (1, 1))
        mod = family_module(tcfg)
        tokens = torch.zeros((2, 8), dtype=torch.int32, device="meta")
        for shard_map in (True, False):
            cfg = tcfg.with_(moe_shard_map=shard_map)
            with logical.use_rules(view, rules):
                params = sharding.shard_params(mod.init(cfg, None, "meta"),
                                               view, rules, glu=True)
                cache = sharding.shard_cache(mod.init_cache(
                    cfg, 4, 16, device="meta"), view, cfg, rules)
                if shard_map:
                    with pytest.raises(NotPorted, match="item 7c"):
                        mod.prefill(cfg, params, {"tokens": tokens}, cache)
                else:
                    logits, _ = mod.prefill(cfg, params, {"tokens": tokens},
                                            cache)
                    assert logits.shape == (2, cfg.padded_vocab)

    def test_expert_shards_pair_gate_and_up(self):
        """Rank (d, m)'s ``experts_wi`` holds its data block of experts and,
        of each, gate columns m and up columns m; ``experts_wo`` the same
        experts' rows m."""
        cfg = get_config("olmoe-1b-7b", reduced=True)
        whole = family_module(cfg).init(cfg, torch.Generator().manual_seed(0))
        wi = whole["layers"][0]["moe"]["experts_wi"]
        wo = whole["layers"][0]["moe"]["experts_wo"]
        e, ff = cfg.moe.n_experts // 2, cfg.moe.d_ff_expert // 2
        for d in range(2):
            for m in range(2):
                view = rank_view((2, 2), ("data", "model"), (d, m))
                local = sharding.shard_params(whole, view, RULES, glu=True)
                got = local["layers"][0]["moe"]
                pairs = wi[:, d * e:(d + 1) * e].unflatten(-1, (2, -1))
                want = pairs[..., m * ff:(m + 1) * ff].flatten(-2)
                assert torch.equal(got["experts_wi"], want)
                assert torch.equal(got["experts_wo"], wo[
                    :, d * e:(d + 1) * e, m * ff:(m + 1) * ff])

    @pytest.mark.parametrize("sizes", [(2, 2), (4, 2), (2, 4), (16, 16)],
                             ids=lambda s: "x".join(map(str, s)))
    @pytest.mark.parametrize("whole", [False, True],
                             ids=["rules", "dense-whole"])
    @pytest.mark.parametrize("dtype", ["fp32", "bf16"])
    def test_chip_smoke_reckons_the_decode_step(self, sizes, whole, dtype):
        """``chip_smoke.py``'s reckonings of phase ``dist-gspmd`` (a decode
        step's collective bytes by kind; K1's, K2's and K4's launches of a
        prefill and a decode step) against the meta count of one rank's
        steps of reduced OLMoE on a rank view; no expert weight is
        gathered."""
        smoke = _smoke()
        rules = smoke.GSPMD_WHOLE_RULES if whole else smoke.GSPMD_RULES
        dt = torch.float32 if dtype == "fp32" else torch.bfloat16
        cfg = get_config("olmoe-1b-7b", reduced=True).with_(
            moe_shard_map=False, dtype=dt, kv_cache_dtype=dt,
            n_heads=16, n_kv_heads=16, head_dim=4,
            moe=dataclasses.replace(get_config("olmoe-1b-7b").moe,
                                    n_experts=16, d_ff_expert=32))
        mod = family_module(cfg)
        view = rank_view(sizes, ("data", "model"), (sizes[0] - 1, 1))
        rows, s = 2, 9
        with logical.use_rules(view, rules):
            params = sharding.shard_params(mod.init(cfg, None, "meta"),
                                           view, rules, glu=True)
            cache = sharding.shard_cache(mod.init_cache(
                cfg, rows * sizes[0], 32, device="meta"), view, cfg, rules)
            tokens = torch.empty((rows, s), dtype=torch.int32,
                                 device="meta")
            pre, _, _ = dryrun.count_step(make_prefill(cfg), (
                params, {"tokens": tokens}, cache), False)
            step, _, _ = dryrun.count_step(make_decode(cfg), (
                params, tokens[:, :1], cache, s), False)
        got = {**step.per_collective, "total": step.collective_bytes}
        assert got == smoke._gspmd_decode_collectives(
            cfg, dict(zip(("data", "model"), sizes)), rows, not whole)
        tiles = smoke._gspmd_serve_launches(cfg, 1)
        for name in ("fused_matmul", "grouped_matmul", "flash_attention"):
            n = sum(tiles[f"{name}_by_tile"].values())
            assert (pre.kernels[name]["calls"]
                    + step.kernels.get(name, {"calls": 0})["calls"]) == n
        assert step.kernels["grouped_matmul"]["calls"] == \
            tiles["grouped_matmul_by_tile"]["decode"]


# ---------------------------------------------------------------------------
# A world of 4 CPU ranks.
# ---------------------------------------------------------------------------

_PORT_PROG = textwrap.dedent("""
    import dataclasses
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
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.base import family_module
        from repro_torch.serving.engine import make_decode, make_prefill

        spec = json.load(open(os.path.join(tmp, "cases.json")))
        inp = {k: torch.from_numpy(v) for k, v in
               np.load(os.path.join(tmp, "inputs.npz")).items()}
        mesh = make_mesh((2, 2), ("data", "model"))
        out = {"data": np.array(mesh.index("data"))}
        base = get_config("olmoe-1b-7b", reduced=True)
        for case, (dtype, rules) in spec["cases"].items():
            dt = getattr(torch, dtype)
            cfg = base.with_(dtype=dt, kv_cache_dtype=dt,
                             moe_shard_map=False,
                             moe=dataclasses.replace(
                                 base.moe, capacity_factor=spec["cap"]))
            mod = family_module(cfg)
            like = mod.init(cfg, None, "meta")
            whole = tree.unflatten(like, [
                inp[f"param/{i:03d}"].to(leaf.dtype)
                for i, leaf in enumerate(tree.leaves(like))])
            local = sharding.shard_params(whole, mesh, rules, glu=True)
            back = sharding.gather_params(local, like, mesh, rules,
                                          glu=True)
            out[f"{case}/round_trip"] = np.array(all(
                torch.equal(a, b) for a, b in
                zip(tree.leaves(back), tree.leaves(whole))))
            with logical.use_rules(mesh, rules):
                cache = sharding.shard_cache(mod.init_cache(
                    cfg, spec["batch"], spec["cache_len"]), mesh, cfg, rules)
                batch = sharding.local_batch(
                    {"tokens": inp["tokens"][:, :spec["s"]]}, mesh)
                steps = sharding.local_batch({"t": inp["tokens"][
                    :, spec["s"]:spec["s"] + spec["steps"]]}, mesh)["t"]
                logits, cache = make_prefill(cfg)(local, batch, cache)
                out[f"{case}/logits/0"] = logits.float()
                for i in range(spec["steps"]):
                    logits, cache = make_decode(cfg)(
                        local, steps[:, i:i + 1], cache, spec["s"] + i)
                    out[f"{case}/logits/{i + 1}"] = logits.float()
        # moe_apply(..., mesh=) on a rank: the whole batch in and out,
        # the leaves the rank's under the active rules, else under
        # EXPERT_PARALLEL_RULES
        from repro_torch.models import moe
        cfg = base.with_(dtype=torch.float32, moe_shard_map=False,
                         moe=dataclasses.replace(
                             base.moe, capacity_factor=spec["cap"]))
        like = family_module(cfg).init(cfg, None, "meta")
        whole = tree.unflatten(like, [
            inp[f"param/{i:03d}"] for i in range(len(tree.leaves(like)))])
        block = {k: v[0] for k, v in whole["layers"][0]["moe"].items()}
        local = sharding.shard_params(block, mesh,
                                      sharding.EXPERT_PARALLEL_RULES,
                                      glu=True)
        out["block/default"] = moe.moe_apply(cfg, local, inp["x"],
                                             mesh=mesh)
        rules = spec["cases"]["rules-fp32"][1]
        local = sharding.shard_params(block, mesh, rules, glu=True)
        with logical.use_rules(mesh, rules):
            out["block/rules"] = moe.moe_apply(cfg, local, inp["x"],
                                               mesh=mesh)
        np.savez(os.path.join(tmp, f"rank{world.rank}.npz"),
                 **{k: np.asarray(v) for k, v in out.items()})


    if __name__ == "__main__":
        run_world(rank_main, 4, (sys.argv[2],), device="cpu",
                  rendezvous=os.path.join(sys.argv[2], "rendezvous"),
                  timeout=float(sys.argv[3]))
""")

#: case -> (dtype, rules)
WORLD_CASES = {"rules-fp32": ("float32", RULES),
               "whole-fp32": ("float32", None),
               "whole-bf16": ("bfloat16", None)}
CACHE_LEN = 24


def _serve_reference(jcfg, jp, tokens):
    """The reference's prefill and decode steps off the mesh: a list of
    logits, one a step."""
    mod = j_family(jcfg)
    cache = mod.init_cache(jcfg, B, CACHE_LEN)
    logits, cache = mod.prefill(jcfg, jp, {"tokens": jnp.asarray(
        tokens[:, :S])}, cache)
    out = [np.asarray(logits)]
    for i in range(STEPS):
        logits, cache = mod.decode_step(jcfg, jp, jnp.asarray(
            tokens[:, S + i:S + i + 1]), cache, jnp.int32(S + i))
        out.append(np.asarray(logits))
    return out


def _serve_in_turn(tcfg, params, tokens, rules):
    """The port's one process under an abstract (data 2, model 2) mesh:
    the dense leaves whole, every rank's MoE partial in turn."""
    mod = family_module(tcfg)
    mesh = abstract_mesh((2, 2), ("data", "model"))
    tokens = torch.from_numpy(tokens)
    with logical.use_rules(mesh, rules):
        cache = mod.init_cache(tcfg, B, CACHE_LEN)
        logits, cache = mod.prefill(tcfg, params, {"tokens": tokens[:, :S]},
                                    cache)
        out = [logits.float().numpy()]
        for i in range(STEPS):
            logits, cache = mod.decode_step(tcfg, params,
                                            tokens[:, S + i:S + i + 1],
                                            cache, S + i)
            out.append(logits.float().numpy())
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the reference's logits off the mesh, the port's in turn by case,
    each rank's results)."""
    tmp = str(tmp_path_factory.mktemp("gspmd_world"))
    smoke = _smoke()
    jcfg = _with_capacity(j_get_config("olmoe-1b-7b", reduced=True).with_(
        dtype=jnp.float32, kv_cache_dtype=jnp.float32, moe_shard_map=False),
        CAP)
    jp = j_family(jcfg).init(jcfg, jax.random.PRNGKey(3))
    leaves = [np.array(x) for x in jax.tree.leaves(jp)]
    tokens = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    x = np.random.default_rng(5).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    np.savez(os.path.join(tmp, "inputs.npz"), tokens=tokens, x=x,
             **{f"param/{i:03d}": x for i, x in enumerate(leaves)})
    cases = {k: (dt, rules if rules is not None
                 else smoke.GSPMD_WHOLE_RULES)
             for k, (dt, rules) in WORLD_CASES.items()}
    with open(os.path.join(tmp, "cases.json"), "w") as f:
        json.dump({"cases": cases, "cap": CAP, "batch": B, "s": S,
                   "steps": STEPS, "cache_len": CACHE_LEN}, f)
    prog = os.path.join(tmp, "port_world.py")
    with open(prog, "w") as f:
        f.write(_PORT_PROG)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, prog, os.path.abspath(SRC), tmp,
         str(WORLD_TIMEOUT - 30)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    ref = _serve_reference(jcfg, jp, tokens)
    block = jax.tree_util.tree_map(lambda v: v[0], jp["layers"][0]["moe"])
    ref_block = np.asarray(j_moe.moe_apply(jcfg, block, jnp.asarray(x)))
    tcfg = _with_capacity(get_config("olmoe-1b-7b", reduced=True).with_(
        moe_shard_map=False), CAP)
    in_turn = {}
    for case, (dt, _) in cases.items():
        dt = getattr(torch, dt)
        c = tcfg.with_(dtype=dt, kv_cache_dtype=dt)
        like = family_module(c).init(c, None, "meta")
        params = tree.unflatten(like, [
            torch.from_numpy(x).to(leaf.dtype)
            for x, leaf in zip(leaves, tree.leaves(like))])
        in_turn[case] = _serve_in_turn(c, params, tokens,
                                       smoke.GSPMD_WHOLE_RULES)
    try:
        _, err = proc.communicate(timeout=WORLD_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        _, err = proc.communicate()
        pytest.fail(f"the world timed out after {WORLD_TIMEOUT} s\n"
                    f"{err[-3000:]}")
    assert proc.returncode == 0, err[-3000:]
    ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
             for r in range(4)]
    return ref, in_turn, ranks, ref_block


class TestWorld:
    @pytest.mark.parametrize("case", ["rules-fp32", "whole-fp32"])
    def test_logits_match_reference_off_mesh(self, world, case):
        """Each rank's rows within 1e-5 of max |logit| of the reference
        served off the mesh, greedy identical: tokens overflow at the
        whole batch's capacity as they do there."""
        ref, _, ranks, _ = world
        n = B // 2
        for out in ranks:
            d = int(out["data"])
            for i in range(STEPS + 1):
                want = ref[i][d * n:(d + 1) * n]
                got = out[f"{case}/logits/{i}"]
                assert got.shape == want.shape
                assert _rel(got, want) <= 1e-5
                np.testing.assert_array_equal(got.argmax(-1),
                                              want.argmax(-1))

    @pytest.mark.parametrize("case", ["whole-fp32", "whole-bf16"])
    def test_ranks_equal_the_partials_in_turn(self, world, case):
        """With the dense leaves whole, each rank's logits equal bit for
        bit the one process's that runs the ranks' partials in turn (each
        axis has two ranks: every sum of partials has two terms)."""
        _, in_turn, ranks, _ = world
        n = B // 2
        for out in ranks:
            d = int(out["data"])
            for i in range(STEPS + 1):
                np.testing.assert_array_equal(
                    out[f"{case}/logits/{i}"],
                    in_turn[case][i][d * n:(d + 1) * n])

    @pytest.mark.parametrize("case", list(WORLD_CASES))
    def test_expert_leaves_round_trip(self, world, case):
        _, _, ranks, _ = world
        assert all(bool(out[f"{case}/round_trip"]) for out in ranks)

    @pytest.mark.parametrize("rules", ["default", "rules"])
    def test_moe_apply_with_the_mesh_on_a_rank(self, world, rules):
        """``moe_apply(..., mesh=)`` on each rank, the whole batch in: under
        ``EXPERT_PARALLEL_RULES`` (no rules active; the experts over
        ``model``) and under ar_gspmd_ep's rules, the whole batch out,
        within 1e-5 of the reference's global block."""
        _, _, ranks, ref_block = world
        for out in ranks:
            got = out[f"block/{rules}"]
            assert got.shape == ref_block.shape
            assert _rel(got, ref_block) <= 1e-5
