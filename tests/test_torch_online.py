"""The port's online serving loop (``repro_torch.serving.online``), its
arrival sources and its span log against the reference's: ``==`` on
every ``OnlineResult`` field, epoch record, per-request outcome, KV
residency counter and span-log digest, through preemption, eviction to
admit, KV eviction and refill, and the SLO-aware planner.
"""

import hashlib
import json

import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.serving import arrivals as jarr                 # noqa: E402
from repro.serving import online as jon                    # noqa: E402
from repro_torch.configs.registry import get_config       # noqa: E402
from repro_torch.obs import SpanAssembler, SpanLog        # noqa: E402
from repro_torch.serving import arrivals as tarr           # noqa: E402
from repro_torch.serving import online as ton              # noqa: E402

ARCH = "yi-6b"


def _digest(log):
    return hashlib.sha256(json.dumps(log.to_json(), sort_keys=True)
                          .encode()).hexdigest()


def _cfgs():
    return j_get_config(ARCH, reduced=True), get_config(ARCH, reduced=True)


# ----- arrival sources -------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda m: m.PoissonArrivals(mean_gap=2500.0, n=12, seed=3),
    lambda m: m.PoissonArrivals(mean_gap=900.0, n=9, seed=0,
                                prompt_lengths=(8, 3, 21)),
    lambda m: m.DeterministicArrivals(gap=3000.0, n=5,
                                      prompt_lengths=(8,)),
    lambda m: m.DeterministicArrivals(gap=0.0, n=4, min_prompt=4,
                                      max_prompt=9, seed=2),
], ids=("poisson", "poisson-lengths", "deterministic", "gap-zero"))
def test_arrival_sources_equal(make):
    assert [(a.time, a.prompt_len) for a in make(tarr)] == \
        [(a.time, a.prompt_len) for a in make(jarr)]


def test_trace_round_trip_and_rates_equal(tmp_path):
    src = list(tarr.PoissonArrivals(mean_gap=700.0, n=6, seed=1))
    path = tmp_path / "trace.jsonl"
    assert tarr.write_trace(str(path), src) == 6
    ours = [(a.time, a.prompt_len) for a in tarr.TraceArrivals(str(path))]
    ref = [(a.time, a.prompt_len) for a in jarr.TraceArrivals(str(path))]
    assert ours == ref == [(a.time, a.prompt_len) for a in src]
    for qps, freq in ((16.0, 2e9), (3.5, 1.4e9)):
        assert tarr.qps_to_gap(qps, freq) == jarr.qps_to_gap(qps, freq)
        assert tarr.gap_to_qps(4e5, freq) == jarr.gap_to_qps(4e5, freq)


# ----- the closed loop -------------------------------------------------------

CASES = {
    "desim": (dict(max_batch=2, max_new_tokens=6),
              dict(mean_gap=4000.0, n=6, seed=0)),
    "churn": (dict(max_batch=2, max_new_tokens=16, policy="decode-priority",
                   policy_kw={"chunk_tokens": 16},
                   execute_backend="analytical", max_inflight=2,
                   evict_to_admit=True),
              dict(gap=3000.0, n=5, prompt_lengths=(8,))),
    "kv": (dict(max_batch=4, max_new_tokens=8, policy="decode-priority",
                policy_kw={"chunk_tokens": 16}, kv_hot_blocks=6,
                kv_block_tokens=8),
           dict(mean_gap=1500.0, n=8, seed=2, prompt_lengths=(12, 20, 7))),
    "cluster": (dict(max_batch=2, max_new_tokens=4, units=2,
                     overlap="relaxed", execute_backend="desim-cluster"),
                dict(mean_gap=2000.0, n=5, seed=4)),
    "auto-slo": (dict(max_batch=2, max_new_tokens=6, ttft_p99_slo=6e4),
                 dict(mean_gap=1000.0, n=6, seed=5)),
}


def _run(name, mod, amod, cfg):
    eng_kw, src_kw = CASES[name]
    src = (amod.DeterministicArrivals(**src_kw) if "gap" in src_kw
           else amod.PoissonArrivals(**src_kw))
    eng = mod.OnlineServingEngine(cfg, **eng_kw)
    return eng, eng.run(src)


@pytest.mark.parametrize("name", list(CASES))
def test_online_result_equal(name):
    jcfg, tcfg = _cfgs()
    jeng, jres = _run(name, jon, jarr, jcfg)
    teng, tres = _run(name, ton, tarr, tcfg)
    assert tres.summary() == jres.summary()
    assert tres.summary(5e4) == jres.summary(5e4)
    assert repr(tres.requests) == repr(jres.requests)
    assert repr(tres.epochs) == repr(jres.epochs)
    assert tres.ttfts() == jres.ttfts() and tres.itls() == jres.itls()
    assert (tres.makespan, tres.freq_hz) == (jres.makespan, jres.freq_hz)
    assert _digest(tres.span_log) == _digest(jres.span_log)
    assert tres.span_log.validate() == [] == jres.span_log.validate()
    if teng.kv_cache is not None:
        assert teng.kv_cache.counters == jeng.kv_cache.counters
        assert teng.kv_cache.trace_digest() == jeng.kv_cache.trace_digest()


def test_churn_kv_and_slo_cases_exercise_their_paths():
    _, tcfg = _cfgs()
    _, churn = _run("churn", ton, tarr, tcfg)
    assert churn.n_preemptions >= 2 and churn.n_evictions >= 1
    assert {s.phase for s in churn.span_log} >= {"preempted", "evicted",
                                                  "resumed"}
    eng, _ = _run("kv", ton, tarr, tcfg)
    assert eng.kv_cache.counters["evictions"] > 0
    assert eng.kv_cache.counters["refills"] > 0
    _, slo = _run("auto-slo", ton, tarr, tcfg)
    assert all(e.candidate is not None for e in slo.epochs)


def test_qps_sweep_and_saturation_equal():
    jcfg, tcfg = _cfgs()
    kw = dict(n_requests=4, max_batch=2, max_new_tokens=4,
              execute_backend="analytical")
    assert (ton.qps_sweep(tcfg, [2e3, 2e4], **kw)
            == jon.qps_sweep(jcfg, [2e3, 2e4], **kw))
    assert (ton.find_saturation(tcfg, start_qps=5e3, max_points=3, **kw)
            == jon.find_saturation(jcfg, start_qps=5e3, max_points=3, **kw))


def test_exhausted_kv_pool_raises_in_both():
    jcfg, tcfg = _cfgs()
    kw = dict(max_batch=4, max_new_tokens=8, policy="decode-priority",
              policy_kw={"chunk_tokens": 16}, kv_hot_blocks=5,
              kv_block_tokens=8)
    src = dict(mean_gap=800.0, n=8, seed=2, prompt_lengths=(12, 20, 7))
    from repro.serving.kvcache import KVPoolExhausted as JExhausted
    from repro_torch.serving.kvcache import KVPoolExhausted
    with pytest.raises(JExhausted) as jerr:
        jon.OnlineServingEngine(jcfg, **kw).run(jarr.PoissonArrivals(**src))
    with pytest.raises(KVPoolExhausted) as terr:
        ton.OnlineServingEngine(tcfg, **kw).run(tarr.PoissonArrivals(**src))
    assert str(terr.value) == str(jerr.value)


def test_span_assembler_exported_and_equal():
    from repro.obs import SpanAssembler as JAssembler
    logs = []
    for cls in (SpanAssembler, JAssembler):
        asm = cls(n_layers=2)
        asm.observe_arrival(0, 5.0)
        asm.mark(0, "evicted", 9.0)
        logs.append(asm.finalize())
    assert isinstance(logs[0], SpanLog)
    assert logs[0].to_json() == logs[1].to_json()
