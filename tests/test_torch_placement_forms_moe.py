"""OLMoE and Whisper under placements that no experiment's rules give,
served and trained on a rank's shards against the reference under the
same rules (the machinery of ``tests/test_torch_placement_forms.py``).

OLMoE: the experts over every rank in both forms (the ``shard_map``
form's rank takes its ``model`` block of them, as the reference
reshards them to ``P("model")``, and equals the GSPMD form), the expert
leaves split along each expert's d_ff alone in the ``shard_map`` form,
``experts_wo``'s d_ff over the axis ``experts_wi``'s d_model took in the
GSPMD form, and GLU halves of 6 columns over 4 ranks.  Whisper: its q
heads over data (its attention leaves brought to the column/row form),
its GELU MLP kept whole but for ``wo``'s rows, and its self and cross
caches' KV heads over data (a batch the data axis does not split), so
that a rank's caches hold other KV heads than it computes.
"""

import pytest

torch = pytest.importorskip("torch")

import test_torch_placement_forms as forms                # noqa: E402

CASES = {
    "olmoe/experts=data,model/shard_map": (
        "olmoe-1b-7b", (2, 2), {"experts": ("data", "model")},
        {"moe_shard_map": True}),
    "olmoe/experts=data,model/gspmd": (
        "olmoe-1b-7b", (2, 2), {"experts": ("data", "model")},
        {"moe_shard_map": False}),
    "olmoe/experts_by_d_ff/shard_map": (
        "olmoe-1b-7b", (2, 2), {"experts": None, "mlp_expert": "model"},
        {"moe_shard_map": True}),
    "olmoe/mlp_expert=data/gspmd": (
        "olmoe-1b-7b", (2, 2), {"mlp_expert": "data"},
        {"moe_shard_map": False}),
    "olmoe/glu_half_unsplit/gspmd": (
        "olmoe-1b-7b", (2, 2),
        {"experts": None, "embed": None, "mlp_expert": ("data", "model")},
        {"moe_shard_map": False, "d_ff_expert": 6}),
    "whisper/heads=data": ("whisper-tiny", (2, 2), {"heads": "data"}, {}),
    "whisper/mlp=data": ("whisper-tiny", (2, 2), {"mlp": "data"}, {}),
    "whisper/kv_heads_over_data": ("whisper-tiny", (2, 2),
                                   {"batch": None, "kv_heads": "data"}, {}),
}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return forms.run_worlds(
        str(tmp_path_factory.mktemp("placement_forms_moe")), CASES)


@pytest.mark.parametrize("case", list(CASES))
def test_logits_match_reference_meshed(worlds, case):
    forms.check_logits(*worlds, case)


@pytest.mark.parametrize("case", list(CASES))
def test_cache_matches_reference(worlds, case):
    forms.check_cache(*worlds, case)


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_reference_meshed(worlds, case):
    forms.check_step(*worlds, case, forms.leaf_names(case, CASES))


def test_shard_map_equals_gspmd_form(worlds):
    """OLMoE's experts over every rank in the ``shard_map`` form give the
    GSPMD form's logits, loss and first moments on each rank, from the
    same inputs, at a capacity at which no token overflows in either."""
    _, ranks = worlds
    a, b = ("olmoe/experts=data,model/" + f for f in ("shard_map", "gspmd"))
    for out in ranks:
        for i in range(forms.STEPS + 1):
            assert forms._rel(out[f"{a}/logits/{i}"],
                              out[f"{b}/logits/{i}"]) <= forms.TOL_SERVE
        loss = float(out[f"{b}/loss"])
        assert abs(float(out[f"{a}/loss"]) - loss) <= 1e-5 * abs(loss)
        for x, y in zip(forms._leaves(out, f"{a}/mu/"),
                        forms._leaves(out, f"{b}/mu/")):
            assert forms._rel(x, y) <= forms.TOL_GRAD
