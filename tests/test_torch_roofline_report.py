"""The port's roofline report (``repro_torch.launch.roofline``) against the
reference's (``benchmarks/roofline.py``), on the CPU.

Records are written into ``tmp_path`` by the port's dry run
(``launch/dryrun.py::run_cell``) on reduced configurations, for the
meshes ``h100``, ``single`` and ``multi``; the reference's report reads
the same folders through its ``RESULTS``, monkeypatched to ``tmp_path``
(never ``benchmarks/results/``).  Its rows, tables and picks must equal
the reference's on the pods, all but ``hbm_ok``, which the port holds
against the H100's 80 GB where the reference holds a TPU chip's 16 GiB.
The ``h100`` rows, which the reference does not read, are held to the
reference's arithmetic by handing it the same records as a ``single``
folder.
"""

import importlib.util
import json
import shutil
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry as reg          # noqa: E402
from repro_torch.core.hardware import H100_SXM           # noqa: E402
from repro_torch.launch import dryrun, roofline          # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CELLS = [(arch, shape) for arch in ("yi-6b", "olmoe-1b-7b", "rwkv6-7b")
         for shape in ("train_4k", "prefill_32k", "decode_32k")]


def _reference(results, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "_reference_roofline", ROOT / "benchmarks" / "roofline.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "RESULTS", str(results))
    return mod


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The dry run's records of CELLS on the three meshes, reduced (the
    train shape cut to 4 x 32 tokens), under one results directory."""
    out = tmp_path_factory.mktemp("dryrun")
    mp = pytest.MonkeyPatch()
    mp.setattr(dryrun, "get_config", lambda arch, **ov:
               reg.get_config(arch, reduced=True, **ov))
    mp.setitem(reg.SHAPES, "train_4k",
               reg.ShapeSpec("train_4k", 32, 4, "train"))
    try:
        for mesh in dryrun.MESHES:
            for arch, shape in CELLS:
                r = dryrun.run_cell(arch, shape, mesh, out_dir=str(out))
                assert r["status"] == "ok"
    finally:
        mp.undo()
    return out


def _drop_hbm(rows):
    return [{k: v for k, v in r.items() if k != "hbm_ok"} for r in rows]


def test_pod_rows_tables_and_picks_equal_reference(records, monkeypatch):
    ref = _reference(records, monkeypatch)
    ref_rows = ref.load_rows()
    rows = roofline.load_rows(str(records))
    assert {r["mesh"] for r in rows} == {"h100", "single", "multi"}
    assert len(rows) == 3 * len(CELLS)
    pods = [r for r in rows if r["mesh"] != "h100"]
    assert _drop_hbm(pods) == _drop_hbm(ref_rows)
    for mesh in ("single", "multi"):
        assert roofline.render_markdown(rows, mesh) == \
            ref.render_markdown(ref_rows, mesh)
    picks = roofline.pick_hillclimb_cells(rows, "single")
    ref_picks = ref.pick_hillclimb_cells(ref_rows)
    assert {k: _drop_hbm([v]) for k, v in picks.items()} == \
        {k: _drop_hbm([v]) for k, v in ref_picks.items()}


def test_h100_rows_follow_the_reference_arithmetic(records, tmp_path,
                                                   monkeypatch):
    """The reference reads the ``h100`` records handed to it as a
    ``single`` folder: the same rows, table and picks but the mesh's
    name and ``hbm_ok``."""
    shutil.copytree(records / "h100", tmp_path / "single")
    ref = _reference(tmp_path, monkeypatch)
    ref_rows = ref.load_rows()
    rows = roofline.load_rows(str(records))
    ones = [r for r in rows if r["mesh"] == "h100"]
    assert all(r["chips"] == 1 for r in ones)
    assert _drop_hbm([{**r, "mesh": "single"} for r in ones]) == \
        _drop_hbm(ref_rows)
    assert roofline.render_markdown(rows) == ref.render_markdown(ref_rows)
    picks = roofline.pick_hillclimb_cells(rows)
    ref_picks = ref.pick_hillclimb_cells(ref_rows)
    assert {k: (v["arch"], v["shape"]) for k, v in picks.items()} == \
        {k: (v["arch"], v["shape"]) for k, v in ref_picks.items()}


#: (temp bytes, argument bytes, the port's hbm_ok, the reference's)
HBM_CASES = [(1 << 30, 1 << 30, True, True),
             (10 << 30, 10 << 30, True, False),      # 20 GiB
             (40e9, 39.9e9, True, False),
             (40e9, 40e9, False, False),             # 80 GB exactly
             (50e9, 31e9, False, False)]


@pytest.mark.parametrize("temp, args, ours, theirs", HBM_CASES)
def test_hbm_ok_holds_the_h100s_80_gb(records, tmp_path, monkeypatch,
                                      temp, args, ours, theirs):
    assert H100_SXM.hbm_bytes == 80e9
    r = json.loads((records / "h100" / "yi-6b__train_4k.json").read_text())
    r["memory"].update(temp_bytes=temp, argument_bytes=args)
    for mesh in ("h100", "single"):
        (tmp_path / mesh).mkdir()
        (tmp_path / mesh / "yi-6b__train_4k.json").write_text(json.dumps(r))
    rows = roofline.load_rows(str(tmp_path))
    assert [(x["mesh"], x["hbm_ok"]) for x in rows] == [
        ("h100", ours), ("single", ours)]
    ref_rows = _reference(tmp_path, monkeypatch).load_rows()
    assert [x["hbm_ok"] for x in ref_rows] == [theirs]
    assert rows[0]["temp_gb"] == ref_rows[0]["temp_gb"] == temp / 2**30


def test_records_without_a_roofline_are_left_out(records, tmp_path):
    shutil.copytree(records / "h100", tmp_path / "h100")
    (tmp_path / "h100" / "deepseek-67b__train_4k.json").write_text(
        json.dumps({"arch": "deepseek-67b", "shape": "train_4k",
                    "mesh": "h100", "chips": 1, "mode": "train",
                    "status": "not_ported", "reason": "needs a mesh"}))
    rows = roofline.load_rows(str(tmp_path))
    assert [(r["arch"], r["shape"]) for r in rows] == sorted(
        CELLS, key=lambda c: (c[0], roofline._SHAPE_ORDER.index(c[1])))


def test_main_prints_the_tables_and_the_picks(records, capsys, monkeypatch):
    """``python -m repro_torch.launch.roofline --results DIR``: a table a
    mesh, then the picks over ``--mesh`` (``h100`` by default); the tag
    reads ``<mesh><tag>`` folders."""
    rows, picks = roofline.main(["--results", str(records)])
    out = capsys.readouterr().out
    for label in ("one-card (h100)", "single-pod", "multi-pod"):
        assert f"== {label} mesh ==" in out
    assert "== hillclimb picks (h100) ==" in out
    assert all(p["mesh"] == "h100" for p in picks.values())
    assert picks["paper_representative"]["mode"] == "train"
    assert picks["worst_fraction"]["mode"] != "decode"
    assert roofline.render_markdown(rows, "multi") in out
    _, picks = roofline.main(["--results", str(records), "--mesh", "multi"])
    assert all(p["mesh"] == "multi" for p in picks.values())
    assert roofline.main(["--results", str(records), "--tag", "_x"]) == \
        ([], None)


def test_reads_the_dry_runs_results_by_default():
    assert roofline.RESULTS_DIR == dryrun.RESULTS_DIR
    assert roofline.load_rows.__defaults__ == (dryrun.RESULTS_DIR, "")
