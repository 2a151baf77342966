"""Every rule set the reference's experiments use, on every small mesh:
none of them makes the port refuse.

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
(``dryrun.count_step``): none may raise (a ``NotPorted`` names a form the
port does not take), and each counts some FLOPs.
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


def _cases():
    for arch in ALL_ARCHS:
        moe = get_config(arch, reduced=True).moe is not None
        for mesh in MESHES:
            for name in RULESETS:
                if name in MOE_ONLY and not moe:
                    continue
                yield pytest.param(arch, mesh, name,
                                   id=f"{arch}-{mesh[0]}x{mesh[1]}-{name}")


@pytest.mark.parametrize("arch,sizes,ruleset", list(_cases()))
def test_every_cell_runs(monkeypatch, arch, sizes, ruleset):
    for name, spec in SHAPES.items():
        monkeypatch.setitem(registry.SHAPES, name, spec)
    rules, over = RULESETS[ruleset]
    cfg = get_config(arch, reduced=True, **over)
    view = rank_view(sizes, ("data", "model"),
                     (sizes[0] - 1, sizes[1] - 1))
    for name, spec in SHAPES.items():
        with logical.use_rules(view, rules):
            fn, args, _ = dryrun.build_cell(cfg, name, mesh=view,
                                            rules=rules)
            cost, _, _ = dryrun.count_step(fn, args, spec.mode == "train")
        assert cost.flops > 0, name
