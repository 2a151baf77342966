"""GSPMD expert parallelism trained, and the experts over every rank.

``moe_shard_map=False`` under a mesh is the reference's ``else`` branch
of ``moe_apply``: one routing of the whole batch at its capacity, which
GSPMD partitions wherever the rules put the expert leaves, and which
``jax.grad`` differentiates.  The port's rank keeps its expert shards,
gathers the tokens over the batch axes and sums the ranks' fp32
partials with the autograd pairs of ``distributed.collectives``
(``models/moe.py::_moe_gspmd``), so that the step trains; on an
abstract mesh one process runs every rank's partial in turn
(``_moe_gspmd_in_turn``).  The rules ``{"experts": ("data", "model")}``
put n_experts / (data x model) experts on each rank, the block
``block_index(mesh, ("data", "model"))``, data major.

In process: the block's output and its gradients under autograd (the
input, the router and both expert leaves) on an abstract (data 2, model
2) mesh under perf_iter's ar_gspmd_ep rules, the default rules and the
rules over every rank, against the reference's ``jax.grad`` of its
``moe_apply`` off the mesh; each rank's expert block under the rules
over every rank, on rank views; ``chip_smoke.py``'s reckonings of phase
``dist-gspmd``'s train step and of a decode step over every rank,
against the meta count on rank views.

In a gloo world of 4 CPU ranks (``launch.mesh.run_world``) on (data 2,
model 2), reduced OLMoE in fp32 with capacity factor 0.5, so that tokens
overflow at the whole batch's capacity: one AdamW step (2 microbatches
of 4 x 16 tokens, remat "full", the plain torch route) under each of the
three rule sets, every rank's loss within 1e-5 relative and every
gathered first moment (the gradient, (1 - beta1) x its clipped value)
within 1e-4 of its max, against the reference's ``make_train_step`` off
the mesh and against the port's one process under the abstract mesh;
under the rules over every rank, 4 prompts served (a prefill and 2
decode steps), each rank's logits within 1e-5 of max |logit| of the
reference served off the mesh, greedy identical, and
``moe_apply(..., mesh=)`` on each rank against the reference's block.
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
from repro.optim import adamw as j_adamw                      # noqa: E402
from repro.training.train_step import (                        # noqa: E402
    TrainConfig as JTrainConfig, make_train_step as j_make_train_step)
from repro_torch.configs.registry import get_config           # noqa: E402
from repro_torch.core import tree                             # noqa: E402
from repro_torch.distributed import logical, sharding         # noqa: E402
from repro_torch.launch.mesh import abstract_mesh, rank_view  # noqa: E402
from repro_torch.models import moe                            # noqa: E402
from repro_torch.models.base import family_module             # noqa: E402
from repro_torch.models.convert import params_from_jax        # noqa: E402
from repro_torch.optim import adamw                           # noqa: E402
from repro_torch.training.train_step import (                 # noqa: E402
    TrainConfig, make_train_step)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD_TIMEOUT = 300          # seconds
#: rule set -> rules: perf_iter's ar_gspmd_ep, the default rules (the
#: experts over model, embed FSDP over data), the experts over every rank
RULESETS = {"ar_gspmd_ep": {"experts": "data", "mlp_expert": "model",
                            "embed": None},
            "default": None,
            "every_rank": {"experts": ("data", "model")}}
CAP = 0.5
TRAIN_B, TRAIN_S, MB = 8, 16, 2
OPT = dict(lr=3e-4, warmup_steps=1, total_steps=10, eps=1e-2)
B, S, STEPS, CACHE_LEN = 4, 12, 2, 24
#: a gathered first moment's limit, of its leaf's max
TOL_GRAD = 1e-4


def _with_capacity(cfg, factor):
    return cfg.with_(moe=dataclasses.replace(cfg.moe,
                                             capacity_factor=factor))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


# ---------------------------------------------------------------------------
# In process: the block, its gradients, the shards.
# ---------------------------------------------------------------------------

def _block_case(arch):
    jcfg = _with_capacity(j_get_config(arch, reduced=True).with_(
        dtype=jnp.float32), CAP)
    tcfg = _with_capacity(get_config(arch, reduced=True).with_(
        dtype=torch.float32, moe_shard_map=False, backend="torch"), CAP)
    jp = j_moe.moe_init(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    probe = rng.standard_normal(x.shape).astype(np.float32)
    return jcfg, tcfg, jp, x, probe


@pytest.mark.parametrize("rules", list(RULESETS))
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "arctic-480b"])
def test_ranks_in_turn_differentiate_as_the_reference(arch, rules):
    """Under autograd on an abstract (data 2, model 2) mesh, the block's
    output within 1e-5 and the gradients of sum(y * probe) with respect
    to x, the router and both expert leaves within 1e-5 of their max,
    against ``jax.grad`` of the reference's ``moe_apply`` off the mesh."""
    jcfg, tcfg, jp, x, probe = _block_case(arch)

    def loss(p, x_):
        return jnp.sum(j_moe.moe_apply(jcfg, p, x_) * probe)
    ref_y = np.asarray(j_moe.moe_apply(jcfg, jp, jnp.asarray(x)))
    ref_gp, ref_gx = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp)).items()}
    xt = torch.from_numpy(x).requires_grad_()
    mesh = abstract_mesh((2, 2), ("data", "model"))
    with logical.use_rules(mesh, RULESETS[rules]):
        assert any(moe._gspmd_axes(tcfg, mesh)[:2])
        y = moe.moe_apply(tcfg, tp, xt)
    (y * torch.from_numpy(probe)).sum().backward()
    assert _rel(y.detach(), ref_y) <= 1e-5
    assert _rel(xt.grad, ref_gx) <= 1e-5
    for name in ("w_router", "experts_wi", "experts_wo"):
        assert _rel(tp[name].grad, ref_gp[name]) <= 1e-5, name


def test_every_rank_holds_its_data_major_block():
    """Under ``{"experts": ("data", "model")}`` rank (d, m) of (2, 2)
    holds experts [2d + m, 2d + m + 1) of reduced OLMoE's 8, whole in d
    and d_ff; ``_gspmd_axes`` sums over data, then model."""
    cfg = get_config("olmoe-1b-7b", reduced=True).with_(moe_shard_map=False)
    whole = family_module(cfg).init(cfg, torch.Generator().manual_seed(0))
    wi = whole["layers"][0]["moe"]["experts_wi"]
    wo = whole["layers"][0]["moe"]["experts_wo"]
    rules = RULESETS["every_rank"]
    e = cfg.moe.n_experts // 4
    for d in range(2):
        for m in range(2):
            view = rank_view((2, 2), ("data", "model"), (d, m))
            got = sharding.shard_params(whole, view, rules,
                                        glu=True)["layers"][0]["moe"]
            i = 2 * d + m
            assert torch.equal(got["experts_wi"], wi[:, i * e:(i + 1) * e])
            assert torch.equal(got["experts_wo"], wo[:, i * e:(i + 1) * e])
            with logical.use_rules(view, rules):
                assert sharding.block_index(view, ("data", "model")) == i
    with logical.use_rules(abstract_mesh((2, 2), ("data", "model")), rules):
        axes = moe._gspmd_axes(cfg, logical.active_mesh())
    assert axes == (("data", "model"), (), ["data", "model"])


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _small_olmoe(dtype):
    """Reduced OLMoE with 16 heads of 4 and 16 experts of d_ff 32, so
    that every mesh below splits them, ``moe_shard_map=False``."""
    full = get_config("olmoe-1b-7b")
    return get_config("olmoe-1b-7b", reduced=True).with_(
        moe_shard_map=False, dtype=dtype, kv_cache_dtype=dtype,
        backend="torch", n_heads=16, n_kv_heads=16, head_dim=4,
        moe=dataclasses.replace(full.moe, n_experts=16, d_ff_expert=32))


@pytest.mark.parametrize("sizes", [(2, 2), (4, 2), (2, 4), (1, 2), (2, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_chip_smoke_reckons_the_train_step(sizes):
    """``chip_smoke.py``'s reckoning of phase ``dist-gspmd``'s train step
    (its collective bytes by kind under ar_gspmd_ep's rules) against the
    meta count of one rank's step on a rank view: a gradient summed
    twice over an axis, or not at all, would move it."""
    from repro_torch.launch import dryrun
    smoke = _smoke()
    cfg = _small_olmoe(torch.float32)
    rows, seq = 2, 8
    tcfg = TrainConfig(optimizer=adamw.AdamWConfig(**OPT), loss_chunk=seq)
    view = rank_view(sizes, ("data", "model"), (sizes[0] - 1, sizes[1] - 1))
    rules = smoke.GSPMD_RULES
    with logical.use_rules(view, rules):
        params = sharding.shard_params(family_module(cfg).init(
            cfg, None, "meta"), view, rules, glu=True)
        batch = {k: torch.empty((rows, seq), dtype=torch.int32,
                                device="meta") for k in ("tokens", "labels")}
        cost, _, _ = dryrun.count_step(make_train_step(cfg, tcfg), (
            params, adamw.init(tcfg.optimizer, params), batch), True)
    got = {**cost.per_collective, "total": cost.collective_bytes}
    assert got == smoke._gspmd_train_collectives(
        cfg, dict(zip(("data", "model"), sizes)), rows, seq)


@pytest.mark.parametrize("sizes", [(2, 2), (4, 2), (2, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_chip_smoke_reckons_the_decode_step_over_every_rank(sizes):
    """``chip_smoke.py``'s reckoning of a decode step's collective bytes
    under GSPMD_EVERY_RULES (the FSDP gathers of the dense leaves, the
    router's too) against the meta count on a rank view."""
    from repro_torch.launch import dryrun
    from repro_torch.serving.engine import make_decode
    smoke = _smoke()
    cfg = _small_olmoe(torch.float32)
    mod = family_module(cfg)
    rules = smoke.GSPMD_EVERY_RULES
    view = rank_view(sizes, ("data", "model"), (sizes[0] - 1, 1))
    rows, s = 2, 9
    with logical.use_rules(view, rules):
        params = sharding.shard_params(mod.init(cfg, None, "meta"), view,
                                       rules, glu=True)
        cache = sharding.shard_cache(mod.init_cache(
            cfg, rows * sizes[0], 32, device="meta"), view, cfg, rules)
        tokens = torch.empty((rows, 1), dtype=torch.int32, device="meta")
        step, _, _ = dryrun.count_step(make_decode(cfg), (
            params, tokens, cache, s), False)
    got = {**step.per_collective, "total": step.collective_bytes}
    assert got == smoke._gspmd_decode_collectives(
        cfg, dict(zip(("data", "model"), sizes)), rows, True, every=True)


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
        from repro_torch.models import moe
        from repro_torch.models.base import family_module
        from repro_torch.optim import adamw
        from repro_torch.serving.engine import make_decode, make_prefill
        from repro_torch.training.train_step import (TrainConfig,
                                                     make_train_step)

        spec = json.load(open(os.path.join(tmp, "cases.json")))
        inp = {k: torch.from_numpy(v) for k, v in
               np.load(os.path.join(tmp, "inputs.npz")).items()}
        mesh = make_mesh((2, 2), ("data", "model"))
        out = {"data": np.array(mesh.index("data"))}
        base = get_config("olmoe-1b-7b", reduced=True)
        cfg = base.with_(dtype=torch.float32, kv_cache_dtype=torch.float32,
                         moe_shard_map=False, moe=dataclasses.replace(
                             base.moe, capacity_factor=spec["cap"]))

        def whole():
            like = family_module(cfg).init(cfg, None, "meta")
            # copies: a leaf the rules keep whole is its own shard, and a
            # train step writes into it
            return like, tree.unflatten(like, [
                inp[f"param/{i:03d}"].clone()
                for i in range(len(tree.leaves(like)))])

        tcfg = TrainConfig(optimizer=adamw.AdamWConfig(**spec["opt"]),
                           microbatches=spec["mb"], loss_chunk=8)
        train_cfg = cfg.with_(remat="full", backend="torch")
        batch = {"tokens": inp["train/tokens"], "labels": inp["train/labels"]}
        for case, rules in spec["rulesets"].items():
            like, params = whole()
            local = sharding.shard_params(params, mesh, rules, glu=True)
            opt = adamw.init(tcfg.optimizer, local)
            with logical.use_rules(mesh, rules):
                lb = sharding.local_batch(batch, mesh, spec["mb"])
                p, o, m, _ = make_train_step(train_cfg, tcfg)(local, opt, lb)
                mu = sharding.gather_params(o["mu"], like, mesh, rules,
                                            glu=True)
            out[f"{case}/loss"] = m["loss"]
            out[f"{case}/held"] = np.array(
                local["layers"][0]["moe"]["experts_wi"].shape)
            for i, x in enumerate(tree.leaves(mu)):
                out[f"{case}/mu/{i:03d}"] = x

        # the rules over every rank, served
        rules = spec["rulesets"]["every_rank"]
        mod = family_module(cfg)
        like, params = whole()
        local = sharding.shard_params(params, mesh, rules, glu=True)
        with logical.use_rules(mesh, rules):
            cache = sharding.shard_cache(mod.init_cache(
                cfg, spec["batch"], spec["cache_len"]), mesh, cfg, rules)
            served = sharding.local_batch(
                {"tokens": inp["tokens"][:, :spec["s"]]}, mesh)
            steps = sharding.local_batch({"t": inp["tokens"][
                :, spec["s"]:spec["s"] + spec["steps"]]}, mesh)["t"]
            logits, cache = make_prefill(cfg)(local, served, cache)
            out["serve/logits/0"] = logits
            for i in range(spec["steps"]):
                logits, cache = make_decode(cfg)(
                    local, steps[:, i:i + 1], cache, spec["s"] + i)
                out[f"serve/logits/{i + 1}"] = logits
        block = {k: v[0] for k, v in params["layers"][0]["moe"].items()}
        local = sharding.shard_params(block, mesh, rules, glu=True)
        with logical.use_rules(mesh, rules):
            out["block"] = moe.moe_apply(cfg, local, inp["x"], mesh=mesh)
        np.savez(os.path.join(tmp, f"rank{world.rank}.npz"),
                 **{k: np.asarray(v) for k, v in out.items()})


    if __name__ == "__main__":
        run_world(rank_main, 4, (sys.argv[2],), device="cpu",
                  rendezvous=os.path.join(sys.argv[2], "rendezvous"),
                  timeout=float(sys.argv[3]))
""")


def _j_config():
    return _with_capacity(j_get_config("olmoe-1b-7b", reduced=True).with_(
        dtype=jnp.float32, kv_cache_dtype=jnp.float32, remat="full"), CAP)


def _t_config():
    return _with_capacity(get_config("olmoe-1b-7b", reduced=True).with_(
        dtype=torch.float32, kv_cache_dtype=torch.float32,
        moe_shard_map=False, remat="full", backend="torch"), CAP)


def _reference(jcfg, jp, batch, tokens, x):
    """The reference off the mesh: one AdamW step (loss, first moment),
    the served logits of each step, the MoE block of layer 0."""
    tcfg = JTrainConfig(optimizer=j_adamw.AdamWConfig(**OPT),
                        microbatches=MB, loss_chunk=8)
    _, opt, metrics, _ = jax.jit(j_make_train_step(jcfg, tcfg))(
        jp, j_adamw.init(tcfg.optimizer, jp),
        {k: jnp.asarray(v) for k, v in batch.items()})
    out = {"loss": float(metrics["loss"]),
           "mu": [np.asarray(m) for m in jax.tree.leaves(opt["mu"])]}
    mod = j_family(jcfg)
    cache = mod.init_cache(jcfg, B, CACHE_LEN)
    logits, cache = mod.prefill(jcfg, jp, {"tokens": jnp.asarray(
        tokens[:, :S])}, cache)
    out["logits"] = [np.asarray(logits)]
    for i in range(STEPS):
        logits, cache = mod.decode_step(jcfg, jp, jnp.asarray(
            tokens[:, S + i:S + i + 1]), cache, jnp.int32(S + i))
        out["logits"].append(np.asarray(logits))
    block = jax.tree_util.tree_map(lambda v: v[0], jp["layers"][0]["moe"])
    out["block"] = np.asarray(j_moe.moe_apply(jcfg, block, jnp.asarray(x)))
    return out


def _in_turn(leaves, batch):
    """The port's one process under an abstract (data 2, model 2) mesh,
    each rule set: (loss, first moment leaves)."""
    cfg = _t_config()
    like = family_module(cfg).init(cfg, None, "meta")
    tcfg = TrainConfig(optimizer=adamw.AdamWConfig(**OPT), microbatches=MB,
                       loss_chunk=8)
    out = {}
    for case, rules in RULESETS.items():
        params = tree.unflatten(like, [torch.from_numpy(x.copy())
                                       for x in leaves])
        with logical.use_rules(abstract_mesh((2, 2), ("data", "model")),
                               rules):
            _, opt, metrics, _ = make_train_step(cfg, tcfg)(
                params, adamw.init(tcfg.optimizer, params),
                {k: torch.from_numpy(v) for k, v in batch.items()})
        out[case] = (float(metrics["loss"]),
                     [m.numpy() for m in tree.leaves(opt["mu"])])
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the reference off the mesh, the port's one process in turn by
    rule set, each rank's results)."""
    tmp = str(tmp_path_factory.mktemp("gspmd_train_world"))
    jcfg = _j_config()
    jp = j_family(jcfg).init(jcfg, jax.random.PRNGKey(3))
    leaves = [np.array(x) for x in jax.tree.leaves(jp)]
    rng = np.random.default_rng(6)
    toks = rng.integers(0, jcfg.vocab_size,
                        (TRAIN_B, TRAIN_S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tokens = rng.integers(0, jcfg.vocab_size, (B, S + STEPS)).astype(
        np.int32)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    np.savez(os.path.join(tmp, "inputs.npz"), tokens=tokens, x=x,
             **{"train/tokens": batch["tokens"],
                "train/labels": batch["labels"]},
             **{f"param/{i:03d}": v for i, v in enumerate(leaves)})
    with open(os.path.join(tmp, "cases.json"), "w") as f:
        json.dump({"rulesets": RULESETS, "cap": CAP, "opt": OPT, "mb": MB,
                   "batch": B, "s": S, "steps": STEPS,
                   "cache_len": CACHE_LEN}, f)
    prog = os.path.join(tmp, "port_world.py")
    with open(prog, "w") as f:
        f.write(_PORT_PROG)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, prog, os.path.abspath(SRC), tmp,
         str(WORLD_TIMEOUT - 30)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    ref = _reference(jcfg, jp, batch, tokens, x)
    in_turn = _in_turn(leaves, batch)
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
    return ref, in_turn, ranks


def _step_holds(loss, mu, ref_loss, ref_mu):
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    assert len(mu) == len(ref_mu) > 0
    worst = max((_rel(a, b), i) for i, (a, b) in enumerate(zip(mu, ref_mu)))
    assert worst[0] <= TOL_GRAD, worst


def _rank_mu(out, case):
    keys = sorted(k for k in out if k.startswith(f"{case}/mu/"))
    return [out[k] for k in keys]


class TestWorld:
    @pytest.mark.parametrize("case", list(RULESETS))
    def test_step_matches_reference_off_mesh(self, world, case):
        """Every rank's loss and gathered first moment against the
        reference's step off the mesh (the default rules' case holds a
        data and a model axis of 2 at once: a gradient summed twice over
        either would double)."""
        ref, _, ranks = world
        for out in ranks:
            _step_holds(float(out[f"{case}/loss"]), _rank_mu(out, case),
                        ref["loss"], ref["mu"])

    @pytest.mark.parametrize("case", list(RULESETS))
    def test_step_matches_the_ranks_in_turn(self, world, case):
        """Every rank's step against the port's one process under the
        abstract mesh, which runs the ranks' partials in turn; and the
        in-turn step against the reference's."""
        ref, in_turn, ranks = world
        loss, mu = in_turn[case]
        _step_holds(loss, mu, ref["loss"], ref["mu"])
        for out in ranks:
            _step_holds(float(out[f"{case}/loss"]), _rank_mu(out, case),
                        loss, mu)

    def test_each_rank_trained_its_shard(self, world):
        """A rank's experts_wi (layers, experts, d, d_ff columns) under
        each rule set: ar_gspmd_ep 4 experts x 32 of 64 d_ff columns a
        half, the default rules 4 experts x 32 of 64 in d, the rules over
        every rank 2 experts whole."""
        _, _, ranks = world
        want = {"ar_gspmd_ep": (2, 4, 64, 64), "default": (2, 4, 32, 128),
                "every_rank": (2, 2, 64, 128)}
        for out in ranks:
            assert {c: tuple(out[f"{c}/held"]) for c in RULESETS} == want

    def test_served_over_every_rank_matches_reference(self, world):
        """Under ``{"experts": ("data", "model")}``, each rank's rows of
        the prefill and decode logits within 1e-5 of max |logit| of the
        reference served off the mesh, greedy identical."""
        ref, _, ranks = world
        n = B // 2
        for out in ranks:
            d = int(out["data"])
            for i in range(STEPS + 1):
                want = ref["logits"][i][d * n:(d + 1) * n]
                got = out[f"serve/logits/{i}"]
                assert got.shape == want.shape
                assert _rel(got, want) <= 1e-5
                np.testing.assert_array_equal(got.argmax(-1),
                                              want.argmax(-1))

    def test_block_over_every_rank_matches_reference(self, world):
        """``moe_apply(..., mesh=)`` on each rank under the rules over
        every rank: the whole batch out, within 1e-5 of the reference's
        block."""
        ref, _, ranks = world
        for out in ranks:
            assert out["block"].shape == ref["block"].shape
            assert _rel(out["block"], ref["block"]) <= 1e-5
