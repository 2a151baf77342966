"""The port's autotuner, tuning caches and tuned dispatch against the
reference's (``repro.tune``, ``repro.backend.get_tuned``): ``==``
throughout.

* the search space, the shape and schedule buckets and the sparse
  round-trip;
* the four shipped cache files, byte for byte the reference's, and the
  full-space autotune of each platform regenerating them byte for byte;
* ``measure_decode_regime`` equal to the reference's dict on every
  platform, and the decode-regime schedule equal step by step;
* ``tuned_config`` / ``get_tuned``: the kwargs the cache resolves,
  explicit kwargs winning, ``k_stream`` dropped for single-unit
  backends, the kill switch, and a route hand-pinned in a cache mapping
  to the port's ``"torch"`` / ``"kernel"``;
* ``plan`` / ``evaluate_schedule`` / ``run_schedule`` with
  ``tuned=True`` on ``desim-cluster``, cycles equal to the reference's;
* the tuned dispatch int8 bit-exact against the unfused reference on
  ``kernel``, ``torch``, ``desim`` and ``desim-cluster``.

Tests write caches only under ``tmp_path``.
"""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import backend as jbackend                    # noqa: E402
from repro import tune as jtune                          # noqa: E402
from repro.core.fusion import NO_OPERANDS as J_NO_OPERANDS  # noqa: E402
from repro.core.fusion import Epilogue as JEpilogue      # noqa: E402
from repro.core.fusion import apply_epilogue as j_apply  # noqa: E402
from repro.core.task import MatMulTask as JMatMulTask    # noqa: E402
from repro.tune import autotune as jautotune             # noqa: E402
from repro.tune import regime as jregime                 # noqa: E402
from repro_torch import backend, tune                    # noqa: E402
from repro_torch.backend import registry                 # noqa: E402
from repro_torch.core.config import CASE_STUDY           # noqa: E402
from repro_torch.core.fusion import Epilogue, cute_matmul  # noqa: E402
from repro_torch.core.hardware import PLATFORMS          # noqa: E402
from repro_torch.core.task import MatMulTask             # noqa: E402
from repro_torch.sim.graph import Granularity            # noqa: E402
from repro_torch.tune import autotune, regime            # noqa: E402
from repro_torch.tune.cache import CACHE_DIR             # noqa: E402
from repro_torch.tune.space import DEFAULT_CONFIG, TunedConfig  # noqa: E402

REF_CACHE = (pathlib.Path(__file__).resolve().parents[1]
             / "src" / "repro" / "tune" / "cache")


def _dicts(configs):
    return [c.to_dict() for c in configs]


class TestSpace:
    def test_default_config_roundtrips_empty(self):
        assert DEFAULT_CONFIG.to_dict() == {}
        assert TunedConfig.from_dict({}) == DEFAULT_CONFIG

    def test_sparse_roundtrip(self):
        cfg = TunedConfig(granularity="panel", k_stream=False)
        d = cfg.to_dict()
        assert d == {"granularity": "panel", "k_stream": False}
        assert TunedConfig.from_dict(d) == cfg
        assert d == jtune.TunedConfig(granularity="panel",
                                      k_stream=False).to_dict()

    def test_fields_equal_the_reference(self):
        ours = [(f.name, f.default)
                for f in dataclasses.fields(TunedConfig)]
        ref = [(f.name, f.default)
               for f in dataclasses.fields(jtune.TunedConfig)]
        assert ours == ref

    def test_unknown_field_rejected(self):
        with pytest.raises(ValueError, match="unknown TunedConfig"):
            TunedConfig.from_dict({"tile_q": 3})

    @pytest.mark.parametrize("shape", [(4, 4096, 4096), (32, 64, 64),
                                       (33, 64, 64), (512, 512, 512)])
    def test_shape_buckets(self, shape):
        assert tune.shape_bucket(*shape) == jtune.shape_bucket(*shape)
        assert tune.bucket_of_task(MatMulTask(*shape)) == \
            jtune.bucket_of_task(JMatMulTask(*shape))
        assert tune.shape_bucket(32, 1, 1) == "decode"
        assert tune.shape_bucket(33, 1, 1) == "prefill"

    def test_schedule_equals_the_reference_step_by_step(self):
        _, sched = regime.decode_regime_schedule()
        _, jsched = jregime.decode_regime_schedule()
        assert len(sched.steps) == len(jsched.steps)
        for ours, ref in zip(sched.steps, jsched.steps):
            assert repr(ours) == repr(ref)
        assert repr(sched) == repr(jsched)
        assert tune.schedule_bucket(sched) == "sched|u2|decode"

    def test_schedule_bucket_kv_pressure_suffix(self):
        _, sched = regime.decode_regime_schedule()
        refill = (0.0,) * (len(sched.layers) - 1) + (4096.0,)
        kv = dataclasses.replace(sched, refill_bytes=refill)
        assert tune.schedule_bucket(kv) == "sched|u2|decode|kv"
        zero = dataclasses.replace(sched,
                                   refill_bytes=(0.0,) * len(sched.layers))
        assert tune.schedule_bucket(zero) == "sched|u2|decode"

    def test_candidates_equal_the_reference(self):
        from repro.core.config import CASE_STUDY as J_CASE_STUDY
        for ours, ref in ((tune.gemm_candidates(CASE_STUDY),
                           jtune.gemm_candidates(J_CASE_STUDY)),
                          (tune.schedule_candidates(CASE_STUDY),
                           jtune.schedule_candidates(J_CASE_STUDY))):
            assert ours[0] == DEFAULT_CONFIG
            assert len(ours) == len(set(ours))
            assert _dicts(ours) == _dicts(ref)

    def test_backend_kwargs_apply_tile_cut(self):
        cfg = TunedConfig(tile_m=32, granularity="layer", fused=False)
        kw = cfg.backend_kwargs(CASE_STUDY)
        assert kw["unit"].m_scp == 32
        assert kw["unit"].n_scp == CASE_STUDY.n_scp
        assert kw["granularity"] == "layer" and kw["fused"] is False


class TestCache:
    ENTRY = {"config": {"granularity": "panel"},
             "metrics": {"speedup": 1.25, "desim_cycles": 123.4567891}}

    def test_save_load_roundtrip(self, tmp_path):
        tune.save_cache("shuttle", {"sched|u2|decode": self.ENTRY},
                        cache_dir=tmp_path)
        loaded = tune.load_cache("shuttle", cache_dir=tmp_path)
        assert loaded["sched|u2|decode"]["config"] == {"granularity": "panel"}
        assert loaded["sched|u2|decode"]["metrics"]["desim_cycles"] == 123.457

    def test_dump_is_byte_deterministic_and_the_reference_s(self):
        a = tune.dump_cache("boom", {"gemm|decode": self.ENTRY})
        b = tune.dump_cache("boom", {"gemm|decode": dict(self.ENTRY)})
        assert a == b == jtune.dump_cache("boom", {"gemm|decode": self.ENTRY})
        assert a.endswith("\n")

    def test_missing_or_mismatched_schema_degrades_to_untuned(self, tmp_path):
        assert tune.load_cache("rocket", cache_dir=tmp_path) == {}
        p = tmp_path / "rocket.json"
        p.write_text('{"schema_version": 999, "entries": {"x": {}}}')
        assert tune.load_cache("rocket", cache_dir=tmp_path) == {}
        assert tune.lookup("rocket", "x", cache_dir=tmp_path) is None
        tune.clear_memo()

    def test_lookup_resolves_config(self, tmp_path):
        tune.save_cache("boom", {"gemm|decode": self.ENTRY},
                        cache_dir=tmp_path)
        cfg = tune.lookup("boom", "gemm|decode", cache_dir=tmp_path)
        assert cfg == TunedConfig(granularity="panel")
        assert tune.lookup("boom", "gemm|prefill", cache_dir=tmp_path) is None
        tune.clear_memo()

    @pytest.mark.parametrize("plat", sorted(PLATFORMS))
    def test_shipped_cache_is_the_reference_s_byte_for_byte(self, plat):
        ours = tune.cache_path(plat)
        assert ours.parent == CACHE_DIR
        assert CACHE_DIR.parts[-3:] == ("repro_torch", "tune", "cache")
        assert ours.read_bytes() == (REF_CACHE / f"{plat}.json").read_bytes()

    @pytest.mark.parametrize("plat", sorted(PLATFORMS))
    def test_committed_caches_self_consistent(self, plat):
        entries = tune.load_cache(plat)
        assert {"gemm|decode", "gemm|prefill", "sched|u2|decode"} \
            <= set(entries)
        for bucket, e in entries.items():
            m = e["metrics"]
            assert m["speedup"] >= 1.0, (plat, bucket)
            assert m["analytical_speedup"] >= 1.0, (plat, bucket)
            TunedConfig.from_dict(e["config"])


class TestAutotune:
    def test_budget_truncates_but_keeps_default(self):
        from repro_torch.configs.registry import get_config
        from repro_torch.serving.engine import _step_layer
        cfg = get_config("yi-6b", reduced=True)
        layers = [_step_layer(cfg, "tune-decode", autotune.DECODE_TOKENS, 1)]
        entry = autotune.autotune_bucket(
            layers, tune.gemm_candidates(CASE_STUDY), PLATFORMS["shuttle"],
            price=autotune.price_workload,
            measure=autotune.measure_workload, budget=1, top_k=2)
        assert entry["proposed"] == 1
        assert entry["config"] == {}
        assert entry["metrics"]["speedup"] == 1.0

    def test_budgeted_run_equals_the_reference_byte_for_byte(self):
        docs = [tune.dump_cache("shuttle", autotune.autotune_platform(
            "shuttle", budget=8, buckets=["gemm|decode"])) for _ in range(2)]
        ref = jtune.dump_cache("shuttle", jautotune.autotune_platform(
            "shuttle", budget=8, buckets=["gemm|decode"]))
        assert docs[0] == docs[1] == ref

    def test_election_invariants_small_budget(self):
        entries = autotune.autotune_platform("kunminghu", budget=6)
        for bucket, e in entries.items():
            m = e["metrics"]
            assert m["speedup"] >= 1.0, bucket
            assert m["analytical_speedup"] >= 1.0, bucket
            assert e["proposed"] == 6 and e["measured"] >= 1

    @pytest.mark.parametrize("plat", sorted(PLATFORMS))
    def test_full_space_regenerates_the_shipped_cache(self, plat):
        doc = tune.dump_cache(plat, autotune.autotune_platform(plat))
        assert doc.encode() == tune.cache_path(plat).read_bytes()

    def test_cli_dry_run_check(self, capsys):
        assert autotune.main(["--platform", "rocket", "--dry-run",
                              "--check"]) == 0
        out = capsys.readouterr().out
        assert out.startswith(tune.cache_path("rocket").read_text())
        assert "rocket     sched|u2|decode" in out


class TestDispatch:
    """Precedence: explicit argument > tuned cache > untuned default."""

    @pytest.mark.parametrize("shape", [(4, 4096, 4096), (512, 512, 512)])
    def test_tuned_config_equals_the_reference(self, shape):
        ours = backend.tuned_config(shape=shape)
        ref = jbackend.tuned_config(shape=shape)
        assert (ours and ours.to_dict()) == (ref and ref.to_dict())
        _, sched = regime.decode_regime_schedule()
        _, jsched = jregime.decode_regime_schedule()
        assert backend.tuned_config(sched=sched).to_dict() == \
            jbackend.tuned_config(sched=jsched).to_dict() == \
            {"granularity": "panel"}

    @pytest.mark.parametrize("name", ["desim-cluster", "analytical",
                                      "desim"])
    def test_get_tuned_kwargs_equal_the_reference(self, name):
        _, sched = regime.decode_regime_schedule()
        _, jsched = jregime.decode_regime_schedule()
        units = {} if name == "desim" else {"units": 2}
        ours = backend.get_tuned(name, sched=sched, **units)
        ref = jbackend.get_tuned(name, sched=jsched, **units)
        for attr in ("granularity", "fused", "units", "k_stream"):
            assert str(getattr(ours, attr, None)) == \
                str(getattr(ref, attr, None)), attr
        assert ours.granularity is Granularity.PANEL

    def test_explicit_argument_wins(self):
        _, sched = regime.decode_regime_schedule()
        eng = backend.get_tuned("desim-cluster", sched=sched, units=2,
                                granularity="layer")
        assert eng.granularity is Granularity.LAYER

    def test_untuned_fallback_on_unknown_bucket(self):
        eng = backend.get_tuned("analytical", bucket="sched|u7|prefill")
        assert eng.granularity is Granularity.TILE and eng.fused

    @pytest.mark.parametrize("name", ["desim", "kernel", "torch"])
    def test_kstream_dropped_for_single_unit_backends(self, name):
        assert backend.tuned_config(shape=(4, 4096, 4096)).k_stream is False
        eng = backend.get_tuned(name, shape=(4, 4096, 4096))
        assert not eng.supports_units

    def test_disable_toggle(self):
        prev = backend.set_tuned_dispatch(False)
        try:
            assert not backend.tuned_dispatch_enabled()
            assert backend.tuned_config(shape=(4, 4096, 4096)) is None
            eng = backend.get_tuned("analytical", shape=(4, 4096, 4096))
            assert eng.k_stream is True
        finally:
            backend.set_tuned_dispatch(prev)

    def test_dispatch_platform_validated(self):
        assert backend.dispatch_platform() == "shuttle"
        with pytest.raises(KeyError):
            backend.set_dispatch_platform("pentium")
        prev = backend.set_dispatch_platform(PLATFORMS["kunminghu"])
        try:
            assert backend.dispatch_platform() == "kunminghu"
            assert backend.tuned_config(shape=(4, 1, 1)).to_dict() == \
                jtune.lookup("kunminghu", "gemm|decode").to_dict()
        finally:
            backend.set_dispatch_platform(prev)

    def test_matmul_route_untouched_without_pin(self, monkeypatch):
        monkeypatch.setattr(registry, "_MATMUL_SET_EXPLICITLY", False)
        assert backend.matmul_backend_string(shape=(4, 4096, 4096)) == \
            "kernel"
        assert backend.matmul_backend_string() == "kernel"

    @pytest.mark.parametrize("route,want", [("xla", "torch"),
                                            ("pallas", "kernel"),
                                            ("auto", "kernel")])
    def test_pinned_route_maps_to_the_port_s(self, tmp_path, monkeypatch,
                                             route, want):
        """A route hand-pinned for ``gemm|decode`` in a cache under
        ``tmp_path`` reaches ``cute_matmul(backend=None)`` at decode
        shapes only; an explicit default and the zoo's shape-free lookup
        ignore it."""
        from repro_torch.kernels.matmul import ops as mm_ops
        from repro_torch.models import common as cm
        from repro_torch.configs.registry import get_config
        tune.save_cache("shuttle", {"gemm|decode": {
            "config": {"route": route}, "metrics": {}}}, cache_dir=tmp_path)
        monkeypatch.setattr(tune.cache, "CACHE_DIR", tmp_path)
        monkeypatch.setattr(registry, "_MATMUL_SET_EXPLICITLY", False)
        tune.clear_memo()
        try:
            assert backend.matmul_backend_string(shape=(4, 64, 64)) == want
            assert backend.matmul_backend_string(shape=(64, 64, 64)) == \
                "kernel"
            assert cm._mm_backend(get_config("yi-6b", reduced=True)) == \
                "kernel"
            calls = []
            inner = mm_ops.fused_matmul
            monkeypatch.setattr(mm_ops, "fused_matmul",
                                lambda *a, **k: calls.append(1) or
                                inner(*a, **k))
            a = torch.randn(4, 64)
            b = torch.randn(64, 48)
            out = cute_matmul(a, b)
            assert bool(calls) == (want == "kernel")
            torch.testing.assert_close(out, a @ b)
            prev = backend.set_default_matmul_backend("torch")
            backend.set_default_matmul_backend(prev)
            assert backend.matmul_backend_string(shape=(4, 64, 64)) == \
                "kernel"
        finally:
            tune.clear_memo()


class TestDecodeRegime:
    @pytest.mark.parametrize("plat", sorted(PLATFORMS))
    def test_measure_decode_regime_equals_the_reference(self, plat):
        m = regime.measure_decode_regime(plat)
        assert m == jregime.measure_decode_regime(plat)
        assert m["tuned_speedup"] >= 1.10, (plat, m)
        assert m["fusion_speedup"] >= 2.0, (plat, m)
        assert m["speedup"] >= m["tuned_speedup"], (plat, m)

    def test_engine_tuned_paths_equal_the_reference(self):
        cycles = {}
        for name, mod in (("port", regime), ("ref", jregime)):
            _, eng = mod.decode_regime_engine()
            sched = eng.plan(max_new_tokens=16, units=2,
                             policy="decode-priority", tuned=True)
            tuned = eng.run_schedule(sched, backend_name="desim-cluster",
                                     tuned=True, workload=False)
            plain = eng.run_schedule(
                eng.plan(max_new_tokens=16, units=2,
                         policy="decode-priority"),
                backend_name="desim-cluster", workload=False)
            _, ev = eng.evaluate_schedule(
                "desim-cluster", max_new_tokens=16, units=2,
                policy="decode-priority", tuned=True, workload=False)
            cycles[name] = (sched.overlap, tuned.cycles, plain.cycles,
                            ev.cycles)
        assert cycles["port"] == cycles["ref"]
        _, tuned, plain, ev = cycles["port"]
        assert plain / tuned >= 1.10 and ev == tuned


class TestFusedBitExact:
    """The tuned dispatch stays int8 bit-exact against the unfused
    matmul + vector reference (the reference's, through numpy)."""

    EP = Epilogue(activation="relu", out_dtype=torch.int32)
    J_EP = JEpilogue(activation="relu", out_dtype=jnp.int32)

    def _pair(self, seed, m, n, k):
        rng = np.random.default_rng(seed)
        return (rng.integers(-8, 8, (m, k)).astype(np.int8),
                rng.integers(-8, 8, (k, n)).astype(np.int8))

    def _ref(self, a, b):
        acc = jnp.matmul(jnp.asarray(a), jnp.asarray(b),
                         preferred_element_type=jnp.int32)
        return np.asarray(j_apply(acc, self.J_EP, J_NO_OPERANDS))

    @pytest.mark.parametrize("name", ["kernel", "torch", "desim",
                                      "desim-cluster"])
    @pytest.mark.parametrize("shape", [(16, 128, 256), (128, 128, 256)])
    def test_tuned_dispatch_stays_bit_exact(self, name, shape):
        m, n, k = shape
        a, b = self._pair(8, m, n, k)
        units = {"units": 2} if name == "desim-cluster" else {}
        eng = backend.get_tuned(name, shape=shape, **units)
        g = eng.lower(MatMulTask(m=m, n=n, k=k), epilogue=self.EP)
        res = eng.run_graph(g, backend.MatMulOperands(
            a=torch.from_numpy(a), b=torch.from_numpy(b)))
        np.testing.assert_array_equal(res.output.numpy(), self._ref(a, b))
