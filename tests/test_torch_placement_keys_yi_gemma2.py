"""The one-key sweep (``test_torch_placements.one_key_cases``) of
yi-6b, gemma2-2b: every change of one key of ``DEFAULT_RULES`` on a
(2, 2) rank view, train, prefill and decode cells counted on ``meta``
without an exception."""

import pytest

torch = pytest.importorskip("torch")

import test_torch_placements as sweep                     # noqa: E402

ARCHS = ('yi-6b', 'gemma2-2b')


@pytest.mark.parametrize("arch,rules,over",
                         list(sweep.one_key_cases(ARCHS)))
def test_one_key_change_runs(monkeypatch, arch, rules, over):
    sweep.run_cells(monkeypatch, arch, (2, 2), rules, over)
