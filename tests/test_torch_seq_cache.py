"""The sequence-sharded KV cache: serving on a model axis that does not
divide the KV heads, against the reference's meshed prefill and decode.

The reference's ``cache_shardings`` gives the model axis to the cache's
KV-head dim when the heads divide it, else to its sequence dim when the
length does (sequence-parallel decode attention), else to neither (the
cache whole on every rank of ``model``).  The port's ``shard_cache``
takes the same forms; a rank computes K and V of every KV head, writes
the rows its positions hold, and a decode step on a sequence-sharded
cache attends over the rank's positions and combines the ranks' row max,
sum of exponentials and P·V.

The multi-rank cases run in two subprocesses on the same numpy inputs,
as ``tests/test_torch_tensor_parallel.py`` runs its own: the reference
on 8 forced host devices, each case's prefill and decode steps jitted
under ``logical.use_rules`` of a mesh over the first devices, with
params, batch and cache placed by ``param_shardings``,
``batch_shardings`` and ``cache_shardings``; the port in a gloo world of
8 CPU ranks (``launch.mesh.run_world``), the ranks of each case's mesh
holding their shards (``shard_params``, ``local_batch``,
``shard_cache``) and serving through ``serving.engine.make_prefill`` /
``make_decode``.  Reduced configurations in fp32, 4 prompts, 2 decode
steps at positions on the last slot of a shard and the first of the
next, the last rank's; gemma2-2b's window (16) masks every position of
the first ranks there.  Limits: logits within 1e-5 of max |logit|, the
gathered cache zero where the reference's is and within 1e-5 of its max
elsewhere (``TOL_CACHE``), greedy tokens identical.

In process: ``shard_cache`` / ``gather_cache`` round trips in the three
forms on rank views, and sequence-parallel decode attention with the
shards run in turn against ``decode_attention`` on the whole cache.
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
from repro_torch.core import tree                         # noqa: E402
from repro_torch.distributed import logical, sharding     # noqa: E402
from repro_torch.distributed import tensor_parallel as tp  # noqa: E402
from repro_torch.kernels.attention.ops import (           # noqa: E402
    decode_attention, decode_attention_merge, decode_attention_partial)
from repro_torch.launch.mesh import rank_view             # noqa: E402
from repro_torch.models.base import family_module         # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
WORLD_TIMEOUT = 300          # seconds, each subprocess
B, STEPS = 4, 2
#: the gathered cache's limit, of a leaf's max.  fp32 products summed in
#: another order than XLA's move the first layer's K and V by 2e-7-4e-7
#: of the max, and the third layer's by up to 1.7e-6 (measured on this
#: file's cases), on every mesh and in both forms alike: the logits'
#: limit, 1e-5, holds them; a row written at a wrong position or head
#: moves it by the order of the max
TOL_CACHE = 1e-5
ARCHS = ("yi-6b", "gemma2-2b", "internvl2-1b", "deepseek-67b",
         "arctic-480b")
#: (cache length, prompt length) by model axis: the sequence form (8
#: slots a rank; decode at the last slot of a shard, then the first of
#: the last rank's) and the whole form (a length the axis does not divide)
LENGTHS = {4: {"seq": (32, 23), "whole": (30, 23)},
           8: {"seq": (64, 55), "whole": (60, 55)}}
#: case -> (arch, (data, model), form)
CASES = {f"{arch}/{d}x{m}/{form}": (arch, (d, m), form)
         for arch, d, m, form in (
             ("yi-6b", 1, 4, "seq"), ("yi-6b", 1, 4, "whole"),
             ("yi-6b", 2, 4, "seq"), ("yi-6b", 2, 4, "whole"),
             ("yi-6b", 1, 8, "seq"), ("yi-6b", 1, 8, "whole"),
             # 4 q heads on 8: every head on every rank (gather_q)
             ("gemma2-2b", 1, 4, "seq"), ("gemma2-2b", 2, 4, "whole"),
             ("gemma2-2b", 1, 8, "seq"), ("gemma2-2b", 1, 8, "whole"),
             ("internvl2-1b", 2, 4, "seq"), ("internvl2-1b", 1, 8, "whole"),
             # 6 q heads on 4 and 8: gather_q
             ("deepseek-67b", 1, 4, "seq"), ("deepseek-67b", 2, 4, "whole"),
             ("deepseek-67b", 1, 8, "seq"),
             ("arctic-480b", 1, 4, "seq"), ("arctic-480b", 2, 4, "whole"),
             ("arctic-480b", 1, 8, "seq"))}

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

    tmp = sys.argv[2]
    spec = json.load(open(os.path.join(tmp, "cases.json")))
    inp = dict(np.load(os.path.join(tmp, "inputs.npz")))
    out = {}
    for case, (arch, shape, form) in spec["cases"].items():
        cache_len, s = spec["lengths"][str(shape[1])][form]
        cfg = get_config(arch, reduced=True).with_(
            dtype=jnp.float32, kv_cache_dtype=jnp.float32)
        mod = family_module(cfg)
        like = jax.eval_shape(lambda k: mod.init(cfg, k),
                              jax.random.PRNGKey(0))
        n = len(jax.tree.leaves(like))
        params = jax.tree.unflatten(jax.tree.structure(like), [
            jnp.asarray(inp[f"{arch}/param/{i:03d}"]) for i in range(n)])
        batch = {"tokens": jnp.asarray(inp[f"{arch}/tokens"][:, :s])}
        if cfg.vision_prefix:
            batch["vision_embeds"] = jnp.asarray(inp[f"{arch}/vision"])
        steps = jnp.asarray(inp[f"{arch}/tokens"][:, s:s + spec["steps"]])
        mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:shape[0] * shape[1]])
        with logical.use_rules(mesh):
            cache = mod.init_cache(cfg, spec["batch"], cache_len)
            params = sharding.apply_shardings(
                params, sharding.param_shardings(params, mesh))
            batch = sharding.apply_shardings(
                batch, sharding.batch_shardings(batch, mesh))
            cache = sharding.apply_shardings(
                cache, sharding.cache_shardings(cache, mesh, cfg))
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
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.base import family_module
        from repro_torch.serving.engine import make_decode, make_prefill

        spec = json.load(open(os.path.join(tmp, "cases.json")))
        inp = {k: torch.from_numpy(v) for k, v in
               np.load(os.path.join(tmp, "inputs.npz")).items()}
        meshes = {}
        out = {}
        for case, (arch, shape, form) in spec["cases"].items():
            shape = tuple(shape)
            if shape not in meshes:          # every rank makes each mesh
                meshes[shape] = make_mesh(shape, ("data", "model"))
            mesh = meshes[shape]
            if not mesh.has_rank:
                continue
            cache_len, s = spec["lengths"][str(shape[1])][form]
            cfg = get_config(arch, reduced=True).with_(
                dtype=torch.float32, kv_cache_dtype=torch.float32)
            mod = family_module(cfg)
            like = mod.init(cfg, None, "meta")
            params = tree.unflatten(like, [
                inp[f"{arch}/param/{i:03d}"]
                for i in range(len(tree.leaves(like)))])
            batch = {"tokens": inp[f"{arch}/tokens"][:, :s]}
            if cfg.vision_prefix:
                batch["vision_embeds"] = inp[f"{arch}/vision"]
            steps = inp[f"{arch}/tokens"][:, s:s + spec["steps"]]
            local = sharding.shard_params(params, mesh, glu=cfg.mlp_glu)
            cache = sharding.shard_cache(
                mod.init_cache(cfg, spec["batch"], cache_len), mesh, cfg)
            out[f"{case}/cache_shape"] = np.array(cache[0][0].shape)
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
        np.savez(os.path.join(tmp, f"rank{world.rank}.npz"),
                 **{k: np.asarray(v) for k, v in out.items()})


    if __name__ == "__main__":
        run_world(rank_main, 8, (sys.argv[2],), device="cpu",
                  rendezvous=os.path.join(sys.argv[2], "rendezvous"),
                  timeout=float(sys.argv[3]))
""")


def _inputs(tmp):
    """The reference's reduced params (fp32) of each arch, seeded tokens
    (prompt and decode steps) and internvl2-1b's vision embeddings."""
    inp = {}
    for i, arch in enumerate(ARCHS):
        cfg = j_get_config(arch, reduced=True).with_(dtype=jnp.float32)
        params = j_family(cfg).init(cfg, jax.random.PRNGKey(2))
        for j, leaf in enumerate(jax.tree.leaves(params)):
            inp[f"{arch}/param/{j:03d}"] = np.asarray(leaf)
        rng = np.random.default_rng(10 + i)
        inp[f"{arch}/tokens"] = rng.integers(
            0, cfg.vocab_size, (B, 64)).astype(np.int32)
        if cfg.vision_prefix:
            inp[f"{arch}/vision"] = rng.standard_normal(
                (B, cfg.vision_prefix, cfg.d_model)).astype(np.float32)
    np.savez(os.path.join(tmp, "inputs.npz"), **inp)
    with open(os.path.join(tmp, "cases.json"), "w") as f:
        json.dump({"cases": CASES, "lengths": LENGTHS, "batch": B,
                   "steps": STEPS}, f)
    return inp


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """(the reference's results, each port rank's results)."""
    tmp = str(tmp_path_factory.mktemp("seq_cache_worlds"))
    _inputs(tmp)
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


def _ranks_of(ranks, case):
    shape = CASES[case][1]
    return ranks[:shape[0] * shape[1]]


class TestServedOnAMesh:
    @pytest.mark.parametrize("case", list(CASES))
    def test_logits_match_reference_meshed(self, worlds, case):
        """Each rank's prefill and decode logits (its batch rows) within
        1e-5 of max |logit| of the reference's meshed ones, the greedy
        tokens identical."""
        ref, ranks = worlds
        for out in _ranks_of(ranks, case):
            data = int(out[f"{case}/data"])
            n = B // CASES[case][1][0]
            for i in range(STEPS + 1):
                want = ref[f"{case}/logits/{i}"][data * n:(data + 1) * n]
                got = out[f"{case}/logits/{i}"]
                assert got.shape == want.shape
                assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
                np.testing.assert_array_equal(got.argmax(-1),
                                              want.argmax(-1))

    @pytest.mark.parametrize("case", list(CASES))
    def test_gathered_cache_matches_reference(self, worlds, case):
        """The cache gathered from every rank's shard (``gather_cache``)
        after the prefill and decode steps: zero where the reference's
        is (no row written out of place) and within TOL_CACHE of its
        max elsewhere; each rank held the form's shard."""
        ref, ranks = worlds
        arch, (_, m), form = CASES[case]
        cfg = reg.get_config(arch, reduced=True)
        cache_len = LENGTHS[m][form][0]
        for out in _ranks_of(ranks, case):
            held = tuple(out[f"{case}/cache_shape"])
            assert held[2:] == (cfg.n_kv_heads, cache_len // m
                                if form == "seq" else cache_len,
                                cfg.head_dim)
            j = 0
            while f"{case}/cache/{j}" in ref:
                want, got = ref[f"{case}/cache/{j}"], out[f"{case}/cache/{j}"]
                assert got.shape == want.shape
                np.testing.assert_array_equal(got == 0, want == 0)
                assert np.abs(got - want).max() <= TOL_CACHE * np.abs(
                    want).max()
                j += 1
            assert j > 0 and f"{case}/cache/{j}" not in out


# ---------------------------------------------------------------------------
# In process: the shards' arithmetic, no world.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("heads, length, form", [
    (4, 32, "heads"), (2, 32, "seq"), (2, 30, "whole")])
def test_shard_and_gather_cache_round_trip(heads, length, form):
    """On rank views of (data 2, model 4), no world: each rank's shard is
    its KV heads, its 8 of 32 positions, or the whole length, at its
    batch rows, and ``cache_placement`` reads the whole back from the
    shard; the shards laid back in place give the cache bit for bit.
    ``gather_cache`` on a rank view records its gathers and returns the
    whole shapes (its values come from a world: the gloo cases above)."""
    cfg = reg.get_config("yi-6b", reduced=True).with_(
        n_kv_heads=heads, n_heads=4 * heads, dtype=torch.float32)
    mod = family_module(cfg)
    cache = mod.init_cache(cfg, 4, length)
    for x in tree.leaves(cache):
        x.copy_(torch.randn(x.shape, generator=torch.Generator().manual_seed(
            x.numel())))
    back = tree.tree_map(torch.zeros_like, cache)
    for r in range(8):
        data, model = divmod(r, 4)
        view = rank_view((2, 4), ("data", "model"), (data, model))
        local = sharding.shard_cache(cache, view, cfg)
        for x, y, whole in zip(tree.leaves(local), tree.leaves(back),
                               tree.leaves(cache)):
            rows = slice(2 * data, 2 * data + 2)
            if form == "heads":
                idx = (slice(None), rows, slice(model, model + 1))
            elif form == "seq":
                idx = (slice(None), rows, slice(None),
                       slice(8 * model, 8 * model + 8))
            else:
                idx = (slice(None), rows)
            assert torch.equal(x, whole[idx])
            y[idx] = x
            with logical.use_rules(view):
                assert sharding.cache_placement(x, cfg, view)[0] == \
                    whole.shape
                # a shard rebuilt from its shape alone: read where only
                # one whole length fits it, refused where two do
                bare = x.clone()
                if form == "whole":
                    with pytest.raises(ValueError, match="shard_cache"):
                        sharding.cache_placement(bare, cfg, view)
                else:
                    assert sharding.cache_placement(bare, cfg, view)[0][
                        2:] == whole.shape[2:]
        gathered = sharding.gather_cache(local, view, cfg)
        assert [x.shape for x in tree.leaves(gathered)] == \
            [x.shape for x in tree.leaves(cache)]
        with logical.use_rules(view):
            shard = tp.current().cache_shard(cfg, local[0][0])
        assert (shard.every_head, shard.split) == (form != "heads",
                                                   form == "seq")
        assert shard.start == (8 * model if form == "seq" else 0)
        assert shard.length == length
    for x, y in zip(tree.leaves(back), tree.leaves(cache)):
        assert torch.equal(x, y)


def test_gather_cache_is_whole_on_an_axis_of_one():
    cfg = reg.get_config("yi-6b", reduced=True).with_(dtype=torch.float32)
    view = rank_view((1, 1), ("data", "model"))
    cache = family_module(cfg).init_cache(cfg, 2, 8)
    back = sharding.gather_cache(sharding.shard_cache(cache, view, cfg),
                                 view, cfg)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(back),
                                                 tree.leaves(cache)))


@pytest.mark.parametrize("shards, cache_len, window, softcap", [
    (4, 23, 0, 0.0), (4, 24, 0, 0.0), (4, 25, 16, 0.0),   # shard 0 masked
    (8, 57, 16, 50.0), (8, 1, 0, 0.0), (2, 32, 0, 30.0)])
def test_split_decode_attention_equals_the_whole(shards, cache_len, window,
                                                 softcap):
    """Sequence-parallel decode attention with the shards run in turn
    (``decode_attention_partial`` on each share of the positions, then
    ``decode_attention_merge`` over a leading dim) against
    ``decode_attention`` on the whole cache, fp32: within 1e-6 of the
    output's max, including shares whose every position is masked (past
    the length, or before the window)."""
    gen = torch.Generator().manual_seed(cache_len)
    b, h, hkv, s, d = 3, 8, 2, 8 * shards, 16
    q = torch.randn((b, h, 1, d), generator=gen)
    k = torch.randn((b, hkv, s, d), generator=gen)
    v = torch.randn((b, hkv, s, d), generator=gen)
    kw = dict(sm_scale=0.25, window=window, softcap=softcap)
    want = decode_attention(q, k, v, cache_len, **kw)
    sc = s // shards
    parts = [decode_attention_partial(
        q, k[:, :, i * sc:(i + 1) * sc], v[:, :, i * sc:(i + 1) * sc],
        cache_len, start=i * sc, **kw) for i in range(shards)]
    m, l, acc = (torch.stack(x) for x in zip(*parts))
    masked = [float(x.abs().max()) == 0.0 for x in l]
    lo = cache_len - window if window else 0
    assert masked == [not any(lo <= p < cache_len
                              for p in range(i * sc, (i + 1) * sc))
                      for i in range(shards)]
    got = decode_attention_merge(
        m, l, acc, reduce_max=lambda t: t.amax(0),
        reduce_sum=lambda t: t.sum(0), dtype=q.dtype)
    assert got.shape == want.shape
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    for i, dead in enumerate(masked):
        if dead:
            assert float(acc[i].abs().max()) == 0.0
