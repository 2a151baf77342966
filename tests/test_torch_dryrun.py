"""The port's front doors against the reference's: the registry's shape
grid and abstract inputs, ``model_flops``, the one-card dry run's JSON
and ``perf_iter``.

The registry and ``model_flops`` are held ``==`` to the reference on
every cell.  The dry run writes the reference's record on mesh ``h100``
(``chips: 1``); the CPU runs one full-width cell (yi-6b ``decode_32k``,
a few seconds on ``meta``) and refusals, and ``perf_iter`` one reduced
experiment, all under ``tmp_path``.
"""

import dataclasses
import json
import os

import jax
import pytest
import torch

from repro.configs import registry as rreg

from repro_torch import NotPorted
from repro_torch.configs import registry as reg
from repro_torch.launch import dryrun, perf_iter
from repro_torch.training.train_step import TrainConfig


def _reference_dryrun():
    """``repro.launch.dryrun``: it sets ``XLA_FLAGS`` (512 host devices)
    when imported.  The backend is made first, so the flag cannot reach
    this process, and the environment is put back for later
    subprocesses."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


ALL = list(rreg.all_cells(include_skipped=True))


def test_grid_equals_reference():
    assert reg.ALL_ARCHS == rreg.ALL_ARCHS
    assert reg.LONG_CONTEXT_ARCHS == rreg.LONG_CONTEXT_ARCHS
    assert {k: dataclasses.asdict(v) for k, v in reg.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in rreg.SHAPES.items()}
    assert list(reg.all_cells()) == list(rreg.all_cells())
    assert list(reg.all_cells(include_skipped=True)) == ALL
    assert [reg.cell_applicable(a, s) for a, s in ALL] == \
        [rreg.cell_applicable(a, s) for a, s in ALL]


def _specs(specs):
    return {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in specs.items()}


@pytest.mark.parametrize("arch, shape", ALL)
def test_input_specs_equal_reference(arch, shape):
    port = reg.input_specs(reg.get_config(arch), shape)
    ref = rreg.input_specs(rreg.get_config(arch), shape)
    assert _specs(port) == _specs(ref)
    assert all(v.device.type == "meta" for v in port.values())
    for mode in ("train", "prefill", "decode"):
        assert _specs(reg.input_specs(reg.get_config(arch), shape, mode)) \
            == _specs(rreg.input_specs(rreg.get_config(arch), shape, mode))


@pytest.mark.parametrize("arch, shape", ALL)
def test_model_flops_equal_reference(arch, shape):
    ref = _reference_dryrun()
    assert dryrun.model_flops(reg.get_config(arch), shape) == \
        ref.model_flops(rreg.get_config(arch), shape)


@pytest.mark.parametrize("arch", ["yi-6b", "internvl2-1b", "whisper-tiny"])
def test_concrete_batch_mirrors_reference(arch):
    cfg, rcfg = (reg.get_config(arch, reduced=True),
                 rreg.get_config(arch, reduced=True))
    a = reg.concrete_batch(cfg, 2, 12, "train", torch.Generator()
                           .manual_seed(0))
    b = reg.concrete_batch(cfg, 2, 12, "train", torch.Generator()
                           .manual_seed(0))
    ref = rreg.concrete_batch(rcfg, 2, 12, "train")
    assert _specs(a) == _specs(ref)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert int(a["tokens"].min()) >= 0
    assert int(a["tokens"].max()) < cfg.vocab_size


def test_default_train_config_bounds_the_carry_by_the_card():
    spec = reg.SHAPES["train_4k"]
    for arch in ("yi-6b", "gemma2-2b", "deepseek-67b"):
        cfg = reg.get_config(arch)
        mb = dryrun.default_train_config(cfg, spec).microbatches
        carry = spec.global_batch * spec.seq_len * cfg.d_model * 2 * \
            cfg.n_layers
        assert carry / mb <= 80e9 < carry / (mb // 2)
    assert dryrun.default_train_config(reg.get_config("yi-6b"),
                                       spec).microbatches == 4


# ---------------------------------------------------------------------------
# run_cell's record.
# ---------------------------------------------------------------------------

REF_KEYS = {"arch", "shape", "mesh", "chips", "mode", "memory",
            "collective_bytes", "unparsed_loops", "model_flops_total",
            "roofline"}
ROOF_KEYS = {"compute_s", "memory_s", "collective_s", "dominant",
             "flops_per_chip", "bytes_per_chip", "coll_bytes_per_chip",
             "model_flops_per_chip", "useful_flops_ratio",
             "roofline_fraction", "chips"}


def test_full_width_decode_cell(tmp_path):
    """yi-6b decode_32k at full size on meta: the reference's record, one
    card, memory-bound, K1 the only kernel (decode attention is plain
    tensor code), every weight read once."""
    dryrun.main(["--arch", "yi-6b", "--shape", "decode_32k",
                 "--out", str(tmp_path)])
    path = tmp_path / "h100" / "yi-6b__decode_32k.json"
    r = json.loads(path.read_text())
    assert REF_KEYS <= set(r) and set(r["roofline"]) == ROOF_KEYS
    assert (r["status"], r["mesh"], r["chips"], r["mode"]) == (
        "ok", "h100", 1, "decode")
    assert r["unparsed_loops"] == 0
    assert r["collective_bytes"] == {"total": 0.0}
    roof = r["roofline"]
    assert roof["dominant"] == "memory" and roof["compute_s"] >= 0
    assert set(r["kernels"]) == {"fused_matmul"}
    # 32 layers x 6 projections + the logits, each a launch
    assert r["kernels"]["fused_matmul"]["calls"] == 32 * 6 + 1
    cfg = reg.get_config("yi-6b")
    weights = 6_061_035_520 * 2
    mem = r["memory"]
    assert mem["argument_bytes"] == (
        weights + 2 * 32 * 128 * cfg.n_kv_heads * 32768 * 128 * 2
        + 128 * 4)
    assert r["kernels"]["fused_matmul"]["bytes"] >= weights - \
        cfg.padded_vocab * cfg.d_model * 2      # the embedding is gathered
    assert mem["temp_bytes"] > 0 and mem["fits_one_card"] is False
    assert r["model_flops_total"] == dryrun.model_flops(cfg, "decode_32k")
    # a second call reads the file back
    assert dryrun.run_cell("yi-6b", "decode_32k", out_dir=str(tmp_path)) \
        == r


@pytest.mark.parametrize("arch, overrides", [
    ("olmoe-1b-7b", None), ("arctic-480b", None), ("rwkv6-7b", None),
    ("recurrentgemma-2b", None), ("whisper-tiny", None),
    ("yi-6b", {"remat": "dots"}), ("yi-6b", {"attn_pv_bf16": True}),
])
def test_train_cells_of_every_family_count(tmp_path, reduced_grid, arch,
                                           overrides):
    """The train cells the port refused before it trained every family,
    and the levers ``remat="dots"`` and ``attn_pv_bf16``, count on the
    reduced grid."""
    r = dryrun.run_cell(arch, "train_4k", overrides=overrides,
                        out_dir=str(tmp_path), tag="_x")
    assert r["status"] == "ok" and r["unparsed_loops"] == 0
    assert (r["chips"], r["mode"]) == (1, "train")
    assert r["kernels"]["fused_matmul"]["calls"] > 0
    assert r["memory"]["temp_bytes"] > 0
    on_disk = json.loads((tmp_path / "h100_x" / f"{arch}__train_4k.json")
                         .read_text())
    assert on_disk == r


@pytest.mark.parametrize("arch, shape", [("olmoe-1b-7b", "train_4k"),
                                         ("rwkv6-7b", "train_4k"),
                                         ("yi-6b", "decode_32k")])
def test_cells_the_port_cannot_run_are_written(tmp_path, reduced_grid,
                                               monkeypatch, arch, shape):
    """A step that raises ``NotPorted`` (an override that needs a mesh,
    say) is written with ``"status": "not_ported"`` and the refusal."""
    def refuse(*args, **kw):
        raise NotPorted("needs a mesh (ROADMAP item 7b)")
    monkeypatch.setattr(dryrun, "count_step", refuse)
    r = dryrun.run_cell(arch, shape, out_dir=str(tmp_path), tag="_x")
    assert r["status"] == "not_ported" and "item 7b" in r["reason"]
    assert (r["chips"], r["mode"]) == (1, reg.SHAPES[shape].mode)
    on_disk = json.loads((tmp_path / "h100_x" / f"{arch}__{shape}.json")
                         .read_text())
    assert on_disk == r


def test_other_errors_fail_the_cell(tmp_path, reduced_grid, monkeypatch):
    """Only the port's refusals (``NotPorted``) are written as
    ``not_ported``: another NotImplementedError raised while counting (a
    missing meta kernel, a wrapper's dtype refusal) fails the cell and
    writes nothing."""
    assert issubclass(NotPorted, NotImplementedError)

    def missing(*args, **kw):
        raise NotImplementedError("no meta kernel for aten.bincount")
    monkeypatch.setattr(dryrun, "count_step", missing)
    with pytest.raises(NotImplementedError, match="bincount"):
        dryrun.run_cell("yi-6b", "decode_32k", out_dir=str(tmp_path))
    assert not list(tmp_path.rglob("*.json"))


@pytest.fixture
def reduced_grid(monkeypatch):
    """The dry run on reduced configs and a small train shape."""
    monkeypatch.setattr(dryrun, "get_config", lambda arch, **ov:
                        reg.get_config(arch, reduced=True, **ov))
    monkeypatch.setitem(reg.SHAPES, "train_4k",
                        reg.ShapeSpec("train_4k", 32, 4, "train"))


def test_reduced_train_cell_counts_the_step(tmp_path, reduced_grid):
    r = dryrun.run_cell("yi-6b", "train_4k", out_dir=str(tmp_path),
                        tcfg=TrainConfig(microbatches=2, loss_chunk=16))
    cfg = reg.get_config("yi-6b", reduced=True)
    assert r["status"] == "ok" and r["unparsed_loops"] == 0
    # 13 K1 launches a layer and microbatch, 2 a loss chunk
    assert r["kernels"]["fused_matmul"]["calls"] == \
        2 * (13 * cfg.n_layers + 2 * 2)
    assert r["memory"]["fits_one_card"] is True
    assert 0 < r["roofline"]["useful_flops_ratio"] < 1


def test_perf_iter_on_a_reduced_experiment(tmp_path, reduced_grid):
    exp = dict(name="yi_mb4", arch="yi-6b", shape="train_4k",
               tcfg=TrainConfig(microbatches=4),
               hypothesis="more microbatches, same FLOPs, less temp")
    got = perf_iter.run_experiment(exp, out_dir=str(tmp_path))
    assert got["status"] == "ok"
    assert got["after"]["flops_per_chip"] == pytest.approx(
        got["before"]["flops_per_chip"], rel=0.05)
    assert (tmp_path / "h100_yi_mb4" / "yi-6b__train_4k.json").exists()
    assert (tmp_path / "h100" / "yi-6b__train_4k.json").exists()


def test_perf_iter_records_what_it_cannot_run(tmp_path, reduced_grid):
    """No experiment is refused: the two of the reference's GSPMD expert
    parallelism (``moe_shard_map=False``, experts over data and their
    d_ff over model) run on the pod mesh, rank 0's program, and on the
    reduced grid ``ar_gspmd_ep``'s collective term lies below its
    baseline's (no expert or FSDP weight gathered); ``g2_seq_parallel``'s
    rules run on the pod mesh (``tests/test_torch_tensor_parallel.py``),
    and the ``attn_pv_bf16`` and ``remat="dots"`` ones run (on the
    reduced grid here).  ``main --only`` writes what it ran."""
    names = {e["name"]: e for e in perf_iter.EXPERIMENTS}
    assert len(names) == 14
    assert not hasattr(perf_iter, "not_ported")
    for name in ("g2_seq_parallel", "ar_gspmd_ep", "ar_combo"):
        assert perf_iter.mesh_of(names[name]) == "single"
    got = perf_iter.run_experiment(names["ar_gspmd_ep"],
                                   out_dir=str(tmp_path))
    assert got["status"] == "ok" and got["mesh"] == "single"
    assert 0 < got["after"]["collective_s"] < got["before"]["collective_s"]
    result = json.loads((tmp_path / "single_ar_gspmd_ep"
                         / "arctic-480b__decode_32k.json").read_text())
    assert result["kernels"]["grouped_matmul"]["calls"] > 0
    perf_iter.main(["--only", "g2_pv_bf16", "--out", str(tmp_path)])
    written = json.loads((tmp_path / "perf_iterations.json").read_text())
    assert [w["name"] for w in written] == ["g2_pv_bf16"]
    assert written[0]["status"] == "ok" and written[0]["speedup"] > 0
