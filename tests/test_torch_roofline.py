"""The port's roofline against the reference's: ``Roofline.as_dict()`` is
``==`` on identical inputs when the port's ``GpuChip`` carries the
reference chip's numbers (its ``ici_bw_total`` as ``nvlink_bw``), and the
H100's terms read the data sheet's peaks."""

import dataclasses

import pytest

from repro.core import roofline as rroof
from repro.core.hardware import TPU_V5E

from repro_torch.core import roofline as proof
from repro_torch.core.hardware import H100_SXM, GpuChip

TPU_AS_GPU = GpuChip(
    name=TPU_V5E.name, peak_bf16=TPU_V5E.peak_bf16, peak_fp8=0.0,
    peak_int8=TPU_V5E.peak_int8, peak_tf32=0.0, peak_fp32=0.0,
    hbm_bw=TPU_V5E.hbm_bw, hbm_bytes=TPU_V5E.hbm_bytes,
    smem_per_block=0, sms=1, nvlink_bw=TPU_V5E.ici_bw_total,
    l2_bytes=0.0)

CASES = {
    # flops, bytes, collective bytes, chips, model flops, dtype peak
    "compute": (4.2e15, 1.1e11, 3.0e9, 256, 3.9e15, "bf16"),
    "memory": (2.0e12, 6.0e11, 1.0e8, 256, 1.5e12, "bf16"),
    "collective": (1.0e12, 1.0e9, 4.0e11, 512, 9.0e11, "bf16"),
    "int8": (3.3e14, 2.2e10, 0.0, 1, 3.0e14, "int8"),
    "empty": (0.0, 0.0, 0.0, 1, 0.0, "bf16"),
}


@pytest.mark.parametrize("name", CASES)
def test_as_dict_equals_reference(name):
    f, b, c, chips, mf, dt = CASES[name]
    ref = rroof.Roofline(f, b, c, chips, mf, chip=TPU_V5E, dtype_peak=dt)
    port = proof.Roofline(f, b, c, chips, mf, chip=TPU_AS_GPU,
                          dtype_peak=dt)
    assert port.as_dict() == ref.as_dict()
    assert (port.bound_s, port.peak) == (ref.bound_s, ref.peak)


def test_h100_terms():
    r = proof.Roofline(989e12, 3.35e12, 900e9, 1, 494.5e12)
    assert r.chip is H100_SXM
    assert (r.compute_s, r.memory_s, r.collective_s) == pytest.approx(
        (1.0, 1.0, 1.0))
    assert r.roofline_fraction == pytest.approx(0.5)
    i8 = dataclasses.replace(r, dtype_peak="int8")
    assert i8.compute_s == pytest.approx(989 / 1979)


def test_collective_bytes_totals_by_kind():
    per = {"all-reduce": 3.0e6, "all-gather": 8.0e6}
    assert proof.collective_bytes(per) == {
        "all-reduce": 3.0e6, "all-gather": 8.0e6, "total": 1.1e7}
    assert proof.collective_bytes({}) == {"total": 0.0}
    hlo = ("ENTRY %e (p: f32[4]) -> f32[4] {\n"
           "  %a = f32[1024]{0} all-reduce(f32[1024]{0} %p)\n"
           "  %g = bf16[8,512]{1,0} all-gather(bf16[1,512]{1,0} %q)\n}\n")
    ref = rroof.collective_bytes(hlo)
    assert proof.collective_bytes(
        {k: v for k, v in ref.items() if k != "total"}) == ref
