"""The port's copies of the paper's photonic models against the reference.

``repro_torch.core.{photonic_model,energy_model,workloads,accelerator_sim}``
are pure Python like their reference modules.  Every number they give is
held ``==`` to the reference's: each Table I cell, the CNN GEMM traces and
MAC counts, every ``SimResult`` field of every accelerator on every CNN,
the Fig. 5 geometric means and the headline ratios.  Then the reference's
own property and paper-claim tests (``test_photonic_properties.py``,
``test_photonic_sim.py``: 16 tests) run against the port, with the same
hypothesis settings.  About 6 s in one process.
"""

import dataclasses
import math

import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import accelerator_sim as ref_sim
from repro.core import energy_model as ref_em
from repro.core import photonic_model as ref_pm
from repro.core import workloads as ref_wl
from repro_torch.core import accelerator_sim as sim
from repro_torch.core import energy_model as em
from repro_torch.core import photonic_model as pm
from repro_torch.core.accelerator_sim import (
    ACCELS,
    AccelConfig,
    fig5_comparison,
    headline_ratios,
    simulate,
)
from repro_torch.core.photonic_model import PAPER_TABLE_I, max_vector_length, scalability_table
from repro_torch.core.workloads import CNNS, GemmShape, cnn_gemm_trace, total_macs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def comparisons():
    return fig5_comparison(), ref_sim.fig5_comparison()


# ---------------------------------------------------------------------------
# Every number equal to the reference's
# ---------------------------------------------------------------------------

def test_table_i_equals_reference():
    assert scalability_table() == ref_pm.scalability_table()
    assert PAPER_TABLE_I == ref_pm.PAPER_TABLE_I
    for org in ("MWA", "MAW", "AMW"):
        assert dataclasses.asdict(pm.BUDGETS[org]) == dataclasses.asdict(ref_pm.BUDGETS[org])
        for p in (0.0, 1.0, 5.0, 7.5, 10.0, 12.0):
            for dr in (0.5, 1.0, 2.0, 5.0, 10.0):
                assert max_vector_length(org, p, dr) == ref_pm.max_vector_length(org, p, dr)


def test_energy_model_equals_reference():
    assert em.ADC_TABLE == ref_em.ADC_TABLE and em.DAC_TABLE == ref_em.DAC_TABLE
    assert dataclasses.asdict(em.CONST) == dataclasses.asdict(ref_em.CONST)
    for dbm, n in ((1.0, 4), (10.0, 43), (-3.0, 7)):
        assert em.laser_wall_power_mw(dbm, n) == ref_em.laser_wall_power_mw(dbm, n)


@pytest.mark.parametrize("name", list(CNNS))
def test_cnn_trace_equals_reference(name):
    ours = [dataclasses.astuple(g) for g in cnn_gemm_trace(name)]
    assert ours == [dataclasses.astuple(g) for g in ref_wl.cnn_gemm_trace(name)]
    assert total_macs(name) == ref_wl.total_macs(name)
    assert ([g.macs for g in cnn_gemm_trace(name)]
            == [g.macs for g in ref_wl.cnn_gemm_trace(name)])


@pytest.mark.parametrize("accel", list(ACCELS))
def test_simulate_equals_reference(accel):
    assert ACCELS[accel].geometry == ref_sim.ACCELS[accel].geometry
    for workload in sim.WORKLOADS:
        ours = simulate(ACCELS[accel], workload)
        ref = ref_sim.simulate(ref_sim.ACCELS[accel], workload)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref), (accel, workload)
        assert (ours.fps, ours.fps_per_w, ours.fps_per_w_mm2) == (
            ref.fps, ref.fps_per_w, ref.fps_per_w_mm2)


def test_fig5_comparison_equals_reference(comparisons):
    ours, ref = comparisons
    assert list(ours) == list(ref)
    for accel in ours:
        assert ours[accel]["gmean"] == ref[accel]["gmean"], accel
        for workload in sim.WORKLOADS:
            assert (dataclasses.asdict(ours[accel][workload])
                    == dataclasses.asdict(ref[accel][workload]))


def test_headline_ratios_equal_reference(comparisons):
    ours, ref = comparisons
    assert headline_ratios(ours) == ref_sim.headline_ratios(ref)
    assert sim.PAPER_RATIOS == ref_sim.PAPER_RATIOS


# ---------------------------------------------------------------------------
# test_photonic_properties.py, against the port
# ---------------------------------------------------------------------------

class TestLinkBudgetMonotonicity:
    @given(st.sampled_from(["MWA", "MAW", "AMW"]),
           st.floats(0.0, 12.0), st.floats(0.0, 11.0))
    @settings(max_examples=60, deadline=None)
    def test_more_power_never_shrinks_n(self, org, p1, dp):
        n1, _ = max_vector_length(org, p1, 5.0)
        n2, _ = max_vector_length(org, p1 + dp, 5.0)
        assert n2 >= n1

    @given(st.sampled_from(["MWA", "MAW", "AMW"]),
           st.floats(1.0, 9.0), st.floats(0.0, 5.0))
    @settings(max_examples=60, deadline=None)
    def test_faster_rate_never_grows_n(self, org, dr, ddr):
        n1, _ = max_vector_length(org, 10.0, dr)
        n2, _ = max_vector_length(org, 10.0, dr + ddr)
        assert n2 <= n1

    def test_square_orgs_return_square(self):
        for org in ("MAW", "AMW"):
            n, m = max_vector_length(org, 10.0, 1.0)
            assert n == m

    def test_mwa_m_fixed_16(self):
        for p in (1.0, 5.0, 10.0):
            _, m = max_vector_length("MWA", p, 1.0)
            assert m == 16


class TestSimulatorInvariants:
    def test_energy_time_consistency(self):
        cfg = AccelConfig("SPOGA_5", "MWA", 5.0)
        r = simulate(cfg, "googlenet")
        assert r.time_s > 0 and r.energy_j > 0
        assert abs(r.power_w - r.energy_j / r.time_s) / r.power_w < 1e-9

    def test_bigger_workload_never_faster(self):
        cfg = AccelConfig("SPOGA_10", "MWA", 10.0)
        small = simulate(cfg, "shufflenet_v2")   # 0.11 GMAC
        big = simulate(cfg, "resnet50")          # 4.1 GMAC
        assert big.time_s > small.time_s

    def test_more_groups_not_slower(self):
        a = simulate(AccelConfig("s", "MWA", 10.0, n_groups=4), "resnet50")
        b = simulate(AccelConfig("s", "MWA", 10.0, n_groups=16), "resnet50")
        assert b.time_s <= a.time_s
        assert b.power_w >= a.power_w           # more hardware, more watts

    def test_spoga_conversions_scale_with_dots_only(self):
        """ADC count is exactly one per dot product, independent of K."""
        cfg = AccelConfig("s", "MWA", 1.0)
        trace_small_k = [GemmShape("g", m=64, k=100, n=50)]
        trace_large_k = [GemmShape("g", m=64, k=2000, n=50)]
        _, ev1 = sim._run_trace(cfg, trace_small_k)
        _, ev2 = sim._run_trace(cfg, trace_large_k)
        assert ev1["adc"] == ev2["adc"] == 64 * 50


# ---------------------------------------------------------------------------
# test_photonic_sim.py, against the port
# ---------------------------------------------------------------------------

# Published ImageNet-224 MAC counts (within 10% — arch variants differ in
# counting of downsample/aux paths).
PUBLISHED_GMACS = {
    "mobilenet_v2": 0.30,
    "shufflenet_v2": 0.146,
    "resnet50": 4.1,
    "googlenet": 1.5,
}


class TestTableI:
    def test_all_15_cells_exact(self):
        table = scalability_table()
        for row, cells in PAPER_TABLE_I.items():
            for dr, expected in cells.items():
                assert table[row][dr] == expected, (row, dr)


class TestWorkloads:
    @pytest.mark.parametrize("name", list(CNNS))
    def test_mac_counts_near_published(self, name):
        got = total_macs(name) / 1e9
        pub = PUBLISHED_GMACS[name]
        assert 0.6 * pub <= got <= 1.25 * pub, f"{name}: {got:.3f} vs {pub}"

    @pytest.mark.parametrize("name", list(CNNS))
    def test_trace_wellformed(self, name):
        for g in cnn_gemm_trace(name):
            assert g.m > 0 and g.k > 0 and g.n > 0 and g.groups >= 1


class TestFig5:
    @pytest.fixture(scope="class")
    def comparison(self):
        return fig5_comparison()

    def test_headline_ratios_within_band(self, comparison):
        """Every paper ratio reproduced within +-35%."""
        for key, vals in headline_ratios(comparison).items():
            lo, hi = 0.65 * vals["paper"], 1.35 * vals["paper"]
            assert lo <= vals["ours"] <= hi, f"{key}: {vals}"

    def test_spoga_beats_baselines_everywhere(self, comparison):
        """The paper's qualitative claim: SPOGA wins FPS and FPS/W at every
        data rate."""
        for dr in (1, 5, 10):
            s = comparison[f"SPOGA_{dr}"]["gmean"]
            for base in ("DEAPCNN", "HOLYLIGHT"):
                b = comparison[f"{base}_{dr}"]["gmean"]
                assert s["fps"] > b["fps"]
                assert s["fps_per_w"] > b["fps_per_w"]

    def test_conversion_count_structure(self):
        """Sec. III-B: SPOGA needs 1 ADC conversion per dot product; the
        bit-sliced baseline needs 4 per chunk plus SRAM round trips."""
        s = simulate(ACCELS["SPOGA_10"], "resnet50")
        d = simulate(ACCELS["DEAPCNN_10"], "resnet50")
        dots = sum(g.dots * g.groups * g.repeat for g in cnn_gemm_trace("resnet50"))
        assert s.adc_samples == dots
        assert d.adc_samples >= 4 * dots          # >= 4x: chunked + sliced
        assert d.sram_bytes > 8 * s.sram_bytes    # intermediate round trips
        assert d.deas_ops > 0 and s.deas_ops == 0

    def test_fps_monotone_in_datarate_for_spoga(self, comparison):
        fps = [comparison[f"SPOGA_{dr}"]["gmean"]["fps"] for dr in (1, 5, 10)]
        assert fps[0] < fps[1] < fps[2]


def test_gmean_sanity():
    assert math.isclose(sim._gmean([2.0, 8.0]), 4.0)
    assert math.isclose(
        math.exp(sum(map(math.log, [2.0, 8.0])) / 2), 4.0
    )
