"""RWKV-6 under placements that no experiment's rules give, served and
trained on a rank's shards against the reference under the same rules
(the machinery of ``tests/test_torch_placement_forms.py``).

The first three cases crashed with a shape error before the port kept
the WKV state of the heads a rank computes: ``heads`` or ``kv_heads``
kept whole (the state's heads over ``model`` under one, the
projections' under the other), and ``embed`` over ``model`` (the
projections split along their rows, which the time mix took for
columns).  Then the projections over both axes, and the channel mix
split in part (``mlp`` whole, ``w_cm_r`` over ``model``).
"""

import pytest

torch = pytest.importorskip("torch")

import test_torch_placement_forms as forms                # noqa: E402

CASES = {
    "rwkv/heads=None": ("rwkv6-7b", (2, 2), {"heads": None}, {}),
    "rwkv/kv_heads=None": ("rwkv6-7b", (2, 2), {"kv_heads": None}, {}),
    "rwkv/embed=model": ("rwkv6-7b", (2, 2), {"embed": "model"}, {}),
    "rwkv/heads=model,data": ("rwkv6-7b", (2, 2),
                              {"heads": ("model", "data")}, {}),
    "rwkv/mlp=None": ("rwkv6-7b", (2, 2), {"mlp": None}, {}),
}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return forms.run_worlds(
        str(tmp_path_factory.mktemp("placement_forms_rec")), CASES)


@pytest.mark.parametrize("case", list(CASES))
def test_logits_match_reference_meshed(worlds, case):
    forms.check_logits(*worlds, case)


@pytest.mark.parametrize("case", list(CASES))
def test_cache_matches_reference(worlds, case):
    forms.check_cache(*worlds, case)


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_reference_meshed(worlds, case):
    forms.check_step(*worlds, case, forms.leaf_names(case, CASES))
