"""The constraint model (paper Eq. 2) of the port against the reference.

Level 1, ``scaled_config`` and ``scaling_sweep`` are held ``==`` to
``repro.core``'s on identical configurations; the reference's own Eq. 1 /
Eq. 2 cases run again on the port.  Level 2 is re-derived for Hopper
(shared memory, wgmma's units, per-SM shares of the peaks), so it is held
to properties and to the numbers it must give beside K1's compiled tile.
"""

import dataclasses

import pytest

from repro.core import config as rcfg
from repro.core import constraint as rcon
from repro.core.precision import DataType as RDataType

from repro_torch.core import config as pcfg
from repro_torch.core import constraint as con
from repro_torch.core.hardware import GIGA, H100_SXM, TERA
from repro_torch.core.precision import DataType, policy
from repro_torch.kernels.matmul import matmul as mm
from repro_torch.kernels.matmul.ops import default_tiles

CONFIGS = {
    "case_study": rcfg.CASE_STUDY,
    "platform_2tops": rcfg.PLATFORM_2TOPS,
    "scp128": rcfg.CASE_STUDY.with_(m_scp=128, n_scp=128),
    "2x2_8gb": rcfg.MatrixUnitConfig(m_pe=2, n_pe=2, k_pe_bits=256,
                                     bandwidth=8 * GIGA),
    "16x16_64gb": rcfg.MatrixUnitConfig(m_pe=16, n_pe=16,
                                        bandwidth=64 * GIGA),
    "3ghz_k128": rcfg.MatrixUnitConfig(freq_hz=3 * GIGA, k_scp_bytes=128),
}
DTYPES = ("INT8", "BF16", "FP16", "FP32")


def _port(cfg):
    return pcfg.MatrixUnitConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("name", CONFIGS)
def test_level1_equals_reference(name, dt):
    ref, port = CONFIGS[name], _port(CONFIGS[name])
    rd, pd = RDataType[dt], DataType[dt]
    assert con.compute_cycles_per_k(port, pd) == \
        rcon.compute_cycles_per_k(ref, rd)
    assert con.memory_cycles_per_k(port, pd) == \
        rcon.memory_cycles_per_k(ref, rd)
    assert con.compute_cycles_per_k(port, pd, 96, 32) == \
        rcon.compute_cycles_per_k(ref, rd, 96, 32)
    assert con.memory_cycles_per_k(port, pd, 96, 32) == \
        rcon.memory_cycles_per_k(ref, rd, 96, 32)
    assert con.feeds_pe_array(port, pd) == rcon.feeds_pe_array(ref, rd)
    assert con.ideal_utilization(port, pd) == rcon.ideal_utilization(ref, rd)
    assert con.paper_eq2_lhs_rhs(port, pd) == rcon.paper_eq2_lhs_rhs(ref, rd)
    assert con.solve_scratchpad(port, pd) == rcon.solve_scratchpad(ref, rd)
    assert con.solve_scratchpad(port, pd, max_tile=64) == \
        rcon.solve_scratchpad(ref, rd, max_tile=64)


@pytest.mark.parametrize("bw_gb", [4, 7, 13, 24, 48, 64, 100, 128])
def test_lower_bandwidth_needs_larger_scratchpad(bw_gb):
    lo = pcfg.MatrixUnitConfig(bandwidth=bw_gb * GIGA)
    hi = pcfg.MatrixUnitConfig(bandwidth=2 * bw_gb * GIGA)
    m_lo, _ = con.solve_scratchpad(lo)
    m_hi, _ = con.solve_scratchpad(hi)
    assert m_lo >= m_hi
    assert (m_lo, m_hi) == (
        rcon.solve_scratchpad(rcfg.MatrixUnitConfig(
            bandwidth=bw_gb * GIGA))[0],
        rcon.solve_scratchpad(rcfg.MatrixUnitConfig(
            bandwidth=2 * bw_gb * GIGA))[0])


def test_scaled_config_and_sweep_equal_reference():
    port = [dataclasses.asdict(c) for c in pcfg.scaling_sweep()]
    ref = [dataclasses.asdict(c) for c in rcfg.scaling_sweep()]
    assert port == ref
    assert dataclasses.asdict(pcfg.scaled_config(4, 4, 512, 48 * GIGA)) == \
        dataclasses.asdict(rcfg.scaled_config(4, 4, 512, 48 * GIGA))


class TestEq1:
    def test_case_study_is_4tops_int8(self):
        assert pcfg.CASE_STUDY.throughput(DataType.INT8) == pytest.approx(
            4.096 * TERA)

    def test_envelope_covers_half_to_32_tops(self):
        tops = [c.throughput(DataType.INT8) / TERA
                for c in pcfg.scaling_sweep()]
        assert min(tops) <= 0.6
        assert max(tops) >= 32.0


class TestEq2:
    def test_paper_printed_form_case_study(self):
        lhs, rhs = con.paper_eq2_lhs_rhs(pcfg.CASE_STUDY)
        assert lhs <= rhs

    def test_case_study_is_memory_limited(self):
        assert con.ideal_utilization(pcfg.CASE_STUDY) == pytest.approx(
            0.75, abs=0.01)

    def test_2tops_config_saturates(self):
        assert con.feeds_pe_array(pcfg.PLATFORM_2TOPS)
        assert con.ideal_utilization(pcfg.PLATFORM_2TOPS) == 1.0

    def test_solver_direction(self):
        m, n = con.solve_scratchpad(pcfg.CASE_STUDY)
        assert con.feeds_pe_array(pcfg.CASE_STUDY.with_(m_scp=m, n_scp=n))

    def test_scaled_configs_satisfy_constraint(self):
        for cfg in pcfg.scaling_sweep():
            assert con.feeds_pe_array(cfg), cfg.describe()


class TestHopperTiles:
    @pytest.mark.parametrize("dt", [DataType.BF16, DataType.FP16,
                                    DataType.INT8])
    @pytest.mark.parametrize("step", [64, 128])
    def test_tile_fits_shared_memory(self, dt, step):
        tc = con.solve_tiles(dt, step=step)
        assert tc.smem_bytes <= H100_SXM.smem_per_block
        assert tc.smem_bytes == con.tile_smem_bytes(
            tc.bm, tc.bn, tc.bk, policy(dt).bytes_per_elem)
        assert tc.bm % con.WGMMA_M == 0
        assert tc.bn % con.WGMMA_N == 0 and tc.bn <= con.WGMMA_N_MAX

    def test_int8_needs_bigger_tiles_than_bf16(self):
        t8 = con.solve_tiles(DataType.INT8)
        t16 = con.solve_tiles(DataType.BF16)
        assert t8.bm > t16.bm

    def test_bf16_answer_is_bandwidth_bound(self):
        """Against HBM alone no tile that fits covers its loads: the
        solver ends on the largest tile, at about a third of the peak."""
        tc = con.solve_tiles(DataType.BF16)
        assert (tc.bm, tc.bn, tc.bk, tc.smem_bytes) == (192, 192, 64,
                                                         196_608)
        assert not tc.compute_bound
        assert tc.ideal_utilization == pytest.approx(0.325, abs=2e-3)

    def test_k1_tile_beside_the_solver(self):
        """Stepping by two warpgroups, the solver lands on K1's compiled
        tensor-core tile; K1's ring fits the block's shared memory."""
        tc = con.solve_tiles(DataType.BF16, step=2 * con.WGMMA_M)
        assert (tc.bm, tc.bn, tc.bk) == (mm.TC_BM, mm.TC_BN, mm.TC_BK)
        assert tc.ideal_utilization == pytest.approx(0.217, abs=2e-3)
        assert con.tile_smem_bytes(mm.TC_BM, mm.TC_BN, mm.TC_BK, 2) \
            <= H100_SXM.smem_per_block
        assert mm.TC_BM == 64 * mm.TC_WG

    def test_step_must_be_whole_warpgroups(self):
        with pytest.raises(ValueError):
            con.solve_tiles(step=96)

    @pytest.mark.parametrize("m, n, k, want", [
        (5, 12, 20, (64, 16, 32)),
        (4, 4096, 4096, (64, 192, 64)),
        (884, 22016, 4096, (192, 192, 64)),
        (200, 130, 70, (192, 136, 64)),
    ])
    def test_default_tiles_clamp_to_problem(self, m, n, k, want):
        assert default_tiles(m, n, k, policy(DataType.BF16)) == want

    def test_ridge_point(self):
        ai = con.arithmetic_intensity_needed(DataType.BF16)
        assert ai == pytest.approx(989 / 3.35)
        assert con.arithmetic_intensity_needed(DataType.INT8) == \
            pytest.approx(1979 / 3.35)

    def test_nvlink_hiding(self):
        # A big matmul hides its weight gather; a tiny one does not.
        assert con.ici_gather_is_hidden(flops_per_chip=1e12,
                                        gather_bytes=1e8)
        assert not con.ici_gather_is_hidden(flops_per_chip=1e9,
                                            gather_bytes=1e9)
        # at the boundary: link time equals compute time
        flops = 989e12 * 1e-3
        assert con.ici_gather_is_hidden(flops, 900e9 * 1e-3 * 0.999)
        assert not con.ici_gather_is_hidden(flops, 900e9 * 1e-3 * 1.001)
