"""RecurrentGemma under placements that no experiment's rules give,
served and trained on a rank's shards against the reference under the
same rules (the machinery of ``tests/test_torch_placement_forms.py``).

The first case crashed with a shape error before the recurrent state
followed the channels the block computes: ``mlp`` kept whole (a conv
state of the rank's channels where the block runs every one).  Then a
GeGLU MLP whose ``wo`` the rules keep whole, the recurrent block split
along its rows, its ``w_gate_in`` and ``w_rnn_out`` over both axes, and
the local-attention ring with its positions over the data axis (a batch
the data axis does not split).
"""

import pytest

torch = pytest.importorskip("torch")

import test_torch_placement_forms as forms                # noqa: E402

CASES = {
    "griffin/mlp=None": ("recurrentgemma-2b", (2, 2), {"mlp": None}, {}),
    "griffin/heads=None": ("recurrentgemma-2b", (2, 2), {"heads": None},
                           {}),
    "griffin/embed=model": ("recurrentgemma-2b", (2, 2),
                            {"embed": "model"}, {}),
    "griffin/mlp=data,model": ("recurrentgemma-2b", (2, 2),
                               {"mlp": ("data", "model")}, {}),
    "griffin/cache_seq_over_data": ("recurrentgemma-2b", (2, 2),
                                    {"batch": None, "heads": "data"}, {}),
}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return forms.run_worlds(
        str(tmp_path_factory.mktemp("placement_forms_griffin")), CASES)


@pytest.mark.parametrize("case", list(CASES))
def test_logits_match_reference_meshed(worlds, case):
    forms.check_logits(*worlds, case)


@pytest.mark.parametrize("case", list(CASES))
def test_cache_matches_reference(worlds, case):
    forms.check_cache(*worlds, case)


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_reference_meshed(worlds, case):
    forms.check_step(*worlds, case, forms.leaf_names(case, CASES))
