"""Every rule set the reference takes, on small meshes: none of them
makes the port raise.

For each registry configuration, reduced, on rank views
(``launch.mesh.rank_view``: one rank's program on ``meta``, each
collective recorded and none run) of (data, model) = (1, 4), (1, 8),
(2, 2) and (2, 4), under the default rules and perf_iter's
``g2_seq_parallel`` rule ``{"seq": "model"}``; for the MoE models also
perf_iter's ``ar_gspmd_ep`` rules and the experts over every rank,
``{"experts": ("data", "model")}``, both with ``moe_shard_map=False``
(the reference's GSPMD branch).  Each case builds a train, a prefill and
a decode cell of 64 tokens through ``launch/dryrun.build_cell`` at the
last rank's coordinate and counts each on ``meta``
(``dryrun.count_step``): none may raise, and each counts some FLOPs.

``one_key_cases`` generates the rest of the sweep, which the
``test_torch_placement_keys_*.py`` files run a few configurations each:
every change of one key of ``DEFAULT_RULES`` (``SWEPT_KEYS``) to each of
``VALUES``, on (2, 2), the MoE configurations in both ``moe_shard_map``
forms.  ``NAMED`` holds a rule set or mesh for each placement that no
change of one key reaches: q heads that straddle KV groups, a cache
whose positions or KV heads lie over the data axis, a GLU whose halves
do not split over the ranks that split the whole, and expert leaves
split along their d_ff only.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry                 # noqa: E402
from repro_torch.configs.registry import (ALL_ARCHS,     # noqa: E402
                                          ShapeSpec, get_config)
from repro_torch.distributed import logical              # noqa: E402
from repro_torch.launch import dryrun                    # noqa: E402
from repro_torch.launch.mesh import rank_view            # noqa: E402

MESHES = ((1, 4), (1, 8), (2, 2), (2, 4))
#: rule set -> (rules, config overrides)
RULESETS = {
    "default": (None, {}),
    "g2_seq_parallel": ({"seq": "model"}, {}),
    "ar_gspmd_ep": ({"experts": "data", "mlp_expert": "model",
                     "embed": None}, {"moe_shard_map": False}),
    "experts_every_rank": ({"experts": ("data", "model")},
                           {"moe_shard_map": False}),
}
MOE_ONLY = ("ar_gspmd_ep", "experts_every_rank")
#: the cells: 64 tokens, 4 rows (2 a data rank on a data axis of 2)
SHAPES = {f"{mode}_64": ShapeSpec(f"{mode}_64", 64, 4, mode)
          for mode in ("train", "prefill", "decode")}
#: the keys of DEFAULT_RULES the one-key sweep changes, and their values
SWEPT_KEYS = ("heads", "kv_heads", "embed", "mlp", "mlp_expert", "vocab",
              "experts", "seq", "seq_shard", "audio_ctx")
VALUES = (None, "data", "model", ("data", "model"), ("model", "data"))
#: the MoE forms: moe_shard_map's value
MOE_FORMS = {"shard_map": True, "gspmd": False}
#: placement -> (configurations (None: every one), meshes, rules,
#: config overrides)
NAMED = {
    # deepseek-67b's 6 q heads of 2 KV groups: 2 q heads a rank on 3
    "q_straddles_kv_groups": (("deepseek-67b",), ((1, 3), (2, 3)), None,
                              {}),
    # a batch the data axis does not split and heads over it: a cache
    # whose KV heads the model axis does not divide takes its positions
    # over data (RecurrentGemma's one KV head on (2, 2); 2 KV heads on 4)
    "cache_seq_over_data": (None, ((2, 2), (2, 4)),
                            {"batch": None, "heads": "data"}, {}),
    # the same batch and the KV heads over data, or over data and model:
    # a cache of other KV heads than the rank computes
    "kv_heads_over_data": (None, ((2, 2),),
                           {"batch": None, "kv_heads": "data"}, {}),
    "kv_heads_over_every_rank": (None, ((2, 2),),
                                 {"batch": None,
                                  "kv_heads": ("data", "model")}, {}),
    # 12 GLU columns over 4 ranks, each half 6: the reference's
    # contiguous shard (gate and up columns apart), gathered whole
    "glu_half_unsplit": (("yi-6b", "gemma2-2b"), ((2, 2),),
                         {"embed": None, "mlp": ("data", "model")},
                         {"d_ff": 6}),
    # the expert leaves split along each expert's d_ff only, both forms
    "experts_by_d_ff": (("olmoe-1b-7b", "arctic-480b"), ((2, 2),),
                        {"experts": None, "mlp_expert": "model"}, {}),
    "experts_by_d_ff_gspmd": (("olmoe-1b-7b", "arctic-480b"), ((2, 2),),
                              {"experts": None, "mlp_expert": "model"},
                              {"moe_shard_map": False}),
    # Arctic's 96 d_ff columns a half on 64 ranks: under GSPMD expert
    # parallelism each expert's d_ff runs whole
    "gspmd_glu_half_unsplit": (("arctic-480b",), ((1, 64),),
                               {"experts": None, "mlp_expert": "model"},
                               {"moe_shard_map": False}),
}


def _cases():
    for arch in ALL_ARCHS:
        moe = get_config(arch, reduced=True).moe is not None
        for mesh in MESHES:
            for name in RULESETS:
                if name in MOE_ONLY and not moe:
                    continue
                yield pytest.param(arch, mesh, name,
                                   id=f"{arch}-{mesh[0]}x{mesh[1]}-{name}")


def _name(value) -> str:
    return "-".join(value) if isinstance(value, tuple) else str(value)


def one_key_cases(archs):
    """pytest params (arch, rules, overrides) of every change of one
    swept key of ``DEFAULT_RULES``, for each of ``archs``, the MoE ones
    in both forms."""
    for arch in archs:
        moe = get_config(arch, reduced=True).moe is not None
        forms = MOE_FORMS if moe else {"": None}
        for key in SWEPT_KEYS:
            for value in VALUES:
                if logical.DEFAULT_RULES[key] == value:
                    continue
                for form, shard_map in forms.items():
                    over = {} if shard_map is None else {
                        "moe_shard_map": shard_map}
                    yield pytest.param(
                        arch, {key: value}, over,
                        id="-".join(filter(None, (arch, f"{key}={_name(value)}",
                                                  form))))


def run_cells(monkeypatch, arch, sizes, rules, over):
    """The train, prefill and decode cells of ``arch`` (reduced, with
    ``over``) at the last rank of a rank view of ``sizes`` under
    ``rules``, each counted on ``meta``: some FLOPs, no exception."""
    for name, spec in SHAPES.items():
        monkeypatch.setitem(registry.SHAPES, name, spec)
    cfg = get_config(arch, reduced=True, **over)
    view = rank_view(sizes, ("data", "model"),
                     (sizes[0] - 1, sizes[1] - 1))
    for name, spec in SHAPES.items():
        with logical.use_rules(view, rules):
            fn, args, _ = dryrun.build_cell(cfg, name, mesh=view,
                                            rules=rules)
            cost, _, _ = dryrun.count_step(fn, args, spec.mode == "train")
        assert cost.flops > 0, name


@pytest.mark.parametrize("arch,sizes,ruleset", list(_cases()))
def test_every_cell_runs(monkeypatch, arch, sizes, ruleset):
    rules, over = RULESETS[ruleset]
    run_cells(monkeypatch, arch, sizes, rules, over)


def _named_cases():
    for name, (archs, meshes, rules, over) in NAMED.items():
        for arch in archs or ALL_ARCHS:
            for mesh in meshes:
                yield pytest.param(arch, mesh, rules, over,
                                   id=f"{name}-{arch}-{mesh[0]}x{mesh[1]}")


@pytest.mark.parametrize("arch,sizes,rules,over", list(_named_cases()))
def test_named_placement_runs(monkeypatch, arch, sizes, rules, over):
    """Each placement of ``NAMED`` counts its three cells."""
    run_cells(monkeypatch, arch, sizes, rules, over)


def _smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _smoke()


@pytest.mark.parametrize("run", list(SMOKE.DIST_FORMS))
def test_chip_smoke_reckons_the_forms(run):
    """``chip_smoke.py``'s reckoning of a decode step's collective bytes
    in each dist-forms run (the model at full width, its depth there, on
    (2, 2)) equals the meta count of the step at every rank's
    coordinate."""
    from repro_torch.distributed import sharding
    from repro_torch.models.base import family_module
    from repro_torch.serving.engine import make_decode
    arch, layers, rules, over = SMOKE.DIST_FORMS[run]
    cfg = SMOKE._forms_config(arch, layers, over)
    mod = family_module(cfg)
    sizes = dict(zip(("data", "model"), SMOKE.DIST_FORMS_MESH))
    rows = SMOKE.MAX_BATCH // sizes["data"]
    want = SMOKE._forms_decode_collectives(cfg, rules, sizes, rows)
    for coord in ((0, 0), (0, 1), (1, 0), (1, 1)):
        view = rank_view(SMOKE.DIST_FORMS_MESH, ("data", "model"), coord)
        with logical.use_rules(view, rules):
            params = sharding.shard_params(mod.init(cfg, None, "meta"),
                                           view, rules, glu=cfg.mlp_glu)
            cache = sharding.shard_cache(mod.init_cache(
                cfg, SMOKE.MAX_BATCH, SMOKE.CACHE_LEN, device="meta"),
                view, cfg, rules)
            tokens = torch.empty((rows, 1), dtype=torch.int32,
                                 device="meta")
            cost, _, _ = dryrun.count_step(make_decode(cfg), (
                params, tokens, cache, 223), False)
        got = {k: float(x) for k, x in cost.per_collective.items()}
        got["total"] = cost.collective_bytes
        assert got == want, coord
