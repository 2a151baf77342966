"""The port's area / power model (paper Table 7) against the reference's:
the same calibration and estimates, held ``==``, and the reference's own
cases run again on the port."""

import dataclasses

import pytest

from repro.core import area as rarea
from repro.core import config as rcfg

from repro_torch.core import config as pcfg
from repro_torch.core.area import estimate
from repro_torch.core.hardware import GIGA

CONFIGS = {
    "case_study": rcfg.CASE_STUDY,
    "platform_2tops": rcfg.PLATFORM_2TOPS,
    "scp128": rcfg.CASE_STUDY.with_(m_scp=128, n_scp=128),
    "4ghz": rcfg.CASE_STUDY.with_(freq_hz=4 * GIGA),
    "2x2": rcfg.CASE_STUDY.with_(m_pe=2, n_pe=2),
    "8x8": rcfg.CASE_STUDY.with_(m_pe=8, n_pe=8),
}


def _port(cfg):
    return pcfg.MatrixUnitConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("name", CONFIGS)
def test_estimate_equals_reference(name):
    ref = rarea.estimate(CONFIGS[name])
    port = estimate(_port(CONFIGS[name]))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.total_mm2, port.total_w) == (ref.total_mm2, ref.total_w)


def test_sweep_equals_reference():
    port = [dataclasses.asdict(estimate(c)) for c in pcfg.scaling_sweep()]
    ref = [dataclasses.asdict(rarea.estimate(c))
           for c in rcfg.scaling_sweep()]
    assert port == ref


def test_table7_calibration_exact():
    ap = estimate(pcfg.CASE_STUDY)
    assert ap.ram_mm2 == pytest.approx(0.164, rel=1e-6)
    assert ap.logic_mm2 == pytest.approx(0.367, rel=1e-6)
    assert ap.total_mm2 == pytest.approx(0.531, rel=1e-3)
    assert ap.total_w == pytest.approx(1.506, rel=1e-3)


def test_area_scales_with_pe_array():
    base = estimate(pcfg.CASE_STUDY)
    small = estimate(pcfg.CASE_STUDY.with_(m_pe=2, n_pe=2))
    big = estimate(pcfg.CASE_STUDY.with_(m_pe=8, n_pe=8))
    assert big.logic_mm2 == pytest.approx(4 * base.logic_mm2, rel=1e-6)
    assert small.logic_mm2 < base.logic_mm2


def test_scratchpad_cost_of_saturating_eq2():
    """The beyond-paper 128x128 scratchpad buys util with ~2.4x the SRAM."""
    sat = estimate(pcfg.CASE_STUDY.with_(m_scp=128, n_scp=128))
    base = estimate(pcfg.CASE_STUDY)
    assert 1.5 < sat.ram_mm2 / base.ram_mm2 < 4.0
    assert sat.total_mm2 < 2 * base.total_mm2


def test_power_scales_with_frequency():
    hi = estimate(pcfg.CASE_STUDY.with_(freq_hz=4 * GIGA))
    assert hi.total_w == pytest.approx(
        2 * estimate(pcfg.CASE_STUDY).total_w, rel=1e-6)
