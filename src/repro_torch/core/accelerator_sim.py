"""Transaction-level simulator for photonic GEMM accelerators — paper Fig. 5.

The port's own copy of ``repro/core/accelerator_sim.py`` (pure Python).

Reimplements the paper's evaluation methodology ("a custom, transaction-level
Python-based simulator", Sec. IV-B): map every Im2Col GEMM of a CNN trace
onto a photonic accelerator, count time steps and electronic events, and
report FPS, FPS/W and FPS/W/mm2 for

* ``SPOGA``       (MWA organization, the paper's design),
* ``HOLYLIGHT``   (MAW organization, ref [3] baseline),
* ``DEAPCNN``     (AMW organization, ref [9] baseline),

each at 1 / 5 / 10 GS/s.  Core geometry (N, M) comes from the calibrated
link budget in ``photonic_model`` (paper Table I).

Comparison normalization — equal **GEMM-group count** per accelerator
(paper Fig. 2a): one SPOGA core processes INT8 natively, while a prior-work
"group" needs **four** INT4 slice cores (Core_1..Core_4) plus the DEAS
post-processing pipeline, exactly as drawn in the paper.

Dataflow semantics (Sec. III):

* SPOGA streams one K-chunk of weights and inputs per time step; the BPCA
  **integrates charge across the ceil(K/N) chunks** of a dot product, so
  exactly one ADC conversion fires per completed dot product and no
  intermediate value is ever stored (3 O/E + 1 ADC per result).
* Prior-work slice cores convert **every lane, every step, every slice**
  (TIA receivers have no temporal memory): 4 ADC conversions per chunk per
  result, an SRAM write+read round trip for each intermediate value, and a
  DEAS shift-add pass to combine the four intermediate matrices.  The DEAS
  SRAM must be sized to buffer the four int32 intermediate matrices of the
  largest layer — the dominant area overhead SPOGA eliminates.

Both stream weights at the photonic data rate (weight-stationary mapping is
incompatible with temporal K-accumulation), so both pay DR-class DACs on
the weight path; SPOGA simply needs far fewer conversions downstream.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import energy_model as em
from repro_torch.core.photonic_model import max_vector_length
from repro_torch.core.workloads import GemmShape, cnn_gemm_trace

__all__ = ["AccelConfig", "SimResult", "simulate", "fig5_comparison", "ACCELS"]


@dataclasses.dataclass(frozen=True)
class AccelConfig:
    name: str
    org: str                  # "MWA" (SPOGA) | "MAW" (HOLYLIGHT) | "AMW" (DEAPCNN)
    datarate_gs: float
    laser_dbm: float = 10.0
    n_groups: int = 8         # SPOGA cores, or 4-slice-core groups (Fig. 2a)

    @property
    def geometry(self) -> tuple[int, int]:
        """(N, M): vector length x dot-product lanes per core."""
        return max_vector_length(self.org, self.laser_dbm, self.datarate_gs)

    @property
    def is_spoga(self) -> bool:
        return self.org == "MWA"


@dataclasses.dataclass
class SimResult:
    name: str
    workload: str
    time_s: float
    energy_j: float
    power_w: float
    area_mm2: float
    adc_samples: float
    sram_bytes: float
    deas_ops: float

    @property
    def fps(self) -> float:
        return 1.0 / self.time_s

    @property
    def fps_per_w(self) -> float:
        return self.fps / self.power_w

    @property
    def fps_per_w_mm2(self) -> float:
        return self.fps_per_w / self.area_mm2


# ---------------------------------------------------------------------------
# Component inventory per GEMM group
# ---------------------------------------------------------------------------

def _group_inventory(cfg: AccelConfig) -> dict:
    """Component counts for one SPOGA core / one 4-slice-core group."""
    n, m = cfg.geometry
    c = em.CONST
    if cfg.is_spoga:
        # One core: N OAMEs x M DPUs. 4 wavelengths per DPU (homodyne fan-in
        # across OAMEs). Input nibbles modulated once per core (shared by
        # all DPUs): 2N DR-class DACs driving 4N modulator rings; per-DPU
        # weight banks: 4N rings fed by 2N DR-class DACs each (streaming).
        # 4 lasers per core: the M-way DPU fanout loss is part of the MWA
        # fixed link-budget lump (photonic_model calibration), so each
        # wavelength needs exactly one source.
        return dict(
            rings=4 * n * (m + 1),
            lasers=4,
            dacs_fast=2 * n + 2 * n * m,   # input + streaming weight DACs
            dacs_slow=0,
            adcs=m,                        # one per DPU (PWAB output)
            oe_receivers=3 * m,            # 3 BPCAs per DPU
            deas_lanes=0,
            sram_kb=4.0 * m,               # output staging only
        )
    # Prior-work group: 4 INT4 slice cores (n x n) + DEAS + intermediate SRAM.
    # The four slice cores process the same operands' nibbles on identical
    # wavelength grids, so the group shares one n-laser comb (split 4 ways).
    # AMW (DEAPCNN) aggregates wavelengths *before* modulation, so every
    # waveguide carries its own n-modulator array (n*n input DACs/core);
    # MAW (HOLYLIGHT) modulates once per core before the split (n DACs).
    mods = n * n if cfg.org == "AMW" else n
    return dict(
        rings=4 * (n * n + n + mods),
        lasers=n,
        dacs_fast=4 * (mods + n * n),      # input + streaming weight DACs
        dacs_slow=0,
        adcs=4 * n,                        # one per waveguide per slice core
        oe_receivers=4 * n,
        deas_lanes=n,
        sram_kb=0.0,                       # sized per workload (intermediates)
    )


def _intermediate_sram_kb(cfg: AccelConfig, trace: list[GemmShape]) -> float:
    """Prior work stores the 4 int32 intermediate matrices in digital memory
    ("these matrices have to be ... stored in digital memory and accessed
    from the memory", Sec. II-D) — sized for the largest layer.
    """
    if cfg.is_spoga:
        return 0.0
    biggest = max(g.m * g.n for g in trace)
    return 4 * biggest * 4 / 1024.0


def _static_power_w(cfg: AccelConfig, inv: dict) -> float:
    c = em.CONST
    mw = (
        em.laser_wall_power_mw(cfg.laser_dbm, inv["lasers"])
        + inv["rings"] * c.mrr_tuning_mw
        + inv["oe_receivers"] * (c.tia_mw + (c.bpca_cap_bank_mw if cfg.is_spoga else 0.0))
        + c.control_mw_per_core * (1 if cfg.is_spoga else 4)
    )
    return mw / 1e3


def _area_mm2(cfg: AccelConfig, inv: dict, sram_kb: float) -> float:
    c = em.CONST
    adc_a, _ = em.adc(cfg.datarate_gs)
    dac_a, _ = em.dac(cfg.datarate_gs)
    return (
        inv["rings"] * c.mrr_area_mm2
        + inv["lasers"] * c.laser_area_mm2
        + inv["dacs_fast"] * dac_a
        + inv["adcs"] * adc_a
        + inv["oe_receivers"] * c.tia_area_mm2
        + inv["deas_lanes"] * c.deas_lane_area_mm2
        + (inv["sram_kb"] + sram_kb) * c.sram_mm2_per_kb
    )


# ---------------------------------------------------------------------------
# Transaction-level execution of one GEMM trace
# ---------------------------------------------------------------------------

def _run_trace(cfg: AccelConfig, trace: list[GemmShape]) -> tuple[float, dict]:
    """-> (time_steps, event counts) for one frame."""
    n, m = cfg.geometry
    groups = cfg.n_groups
    steps = 0.0
    ev = dict(adc=0.0, dac_fast=0.0, sram_bytes=0.0, deas=0.0, oe=0.0)

    for g in trace:
        inst = g.groups * g.repeat
        dots = g.dots * inst                      # results to produce
        if cfg.is_spoga:
            # K INT8 elements per dot; one DPU retires a dot every `chunks`
            # steps (BPCA temporal integration), M dots in flight per core.
            chunks = math.ceil(g.k / n)
            waves = math.ceil(dots / (groups * m))
            steps += waves * chunks
            ev["adc"] += dots                      # single ADC per dot
            ev["oe"] += 3 * dots                   # 3 BPCA transductions
            # DR-class DAC events: inputs 2N per core-step + weights 2N per
            # DPU-step (both stream every step).
            ev["dac_fast"] += waves * chunks * groups * (2 * n + 2 * n * m)
            ev["sram_bytes"] += dots * 4           # final output write only
        else:
            # 4 INT4 slice GEMMs in parallel on the group's 4 cores.
            chunks = math.ceil(g.k / n)
            waves = math.ceil(dots / (groups * n))  # n lanes per slice core
            # The ADC -> SRAM -> DEAS pipeline sustains `post_gops` results
            # per lane per second; above that the photonic front end stalls
            # (the paper's "sluggish DEAS" bottleneck, Sec. II-D). SPOGA
            # never stalls: one conversion per completed dot product.
            throttle = max(1.0, cfg.datarate_gs / em.CONST.post_gops_per_lane)
            steps += waves * chunks * throttle
            conv = dots * chunks * 4               # ADC every chunk x slice
            ev["adc"] += conv
            ev["oe"] += conv
            ev["dac_fast"] += waves * chunks * groups * 4 * (n + n * n)
            # intermediate write + read for DEAS, 4 B each way
            ev["sram_bytes"] += conv * 8 + dots * 4
            ev["deas"] += conv + dots              # shift-adds + final combine
    return steps, ev


def simulate(cfg: AccelConfig, workload: str) -> SimResult:
    trace = cnn_gemm_trace(workload)
    inv = _group_inventory(cfg)
    sram_kb = _intermediate_sram_kb(cfg, trace)
    c = em.CONST

    steps, ev = _run_trace(cfg, trace)
    time_s = steps / (cfg.datarate_gs * 1e9)

    _, adc_mw = em.adc(cfg.datarate_gs)
    _, dac_mw = em.dac(cfg.datarate_gs)
    adc_j = adc_mw * 1e-3 / (cfg.datarate_gs * 1e9)   # energy per sample
    dac_j = dac_mw * 1e-3 / (cfg.datarate_gs * 1e9)

    dyn_j = (
        ev["adc"] * adc_j
        + ev["dac_fast"] * dac_j
        + ev["sram_bytes"] * c.sram_pj_per_byte * 1e-12
        + ev["deas"] * c.deas_pj_per_op * 1e-12
    )
    static_w = cfg.n_groups * _static_power_w(cfg, inv)
    energy_j = dyn_j + static_w * time_s
    power_w = energy_j / time_s
    area = cfg.n_groups * _area_mm2(cfg, inv, sram_kb)

    return SimResult(cfg.name, workload, time_s, energy_j, power_w, area,
                     ev["adc"], ev["sram_bytes"], ev["deas"])


# ---------------------------------------------------------------------------
# Fig. 5 — full comparison
# ---------------------------------------------------------------------------

ACCELS = {
    f"{name}_{int(dr)}": AccelConfig(f"{name}_{int(dr)}", org, dr)
    for name, org in (("SPOGA", "MWA"), ("HOLYLIGHT", "MAW"), ("DEAPCNN", "AMW"))
    for dr in (1.0, 5.0, 10.0)
}

WORKLOADS = ("mobilenet_v2", "shufflenet_v2", "resnet50", "googlenet")


def _gmean(xs) -> float:
    xs = list(xs)
    return math.exp(sum(math.log(x) for x in xs) / len(xs))


def fig5_comparison(workloads=WORKLOADS, accels=None) -> dict:
    """-> {accel: {workload: SimResult, "gmean": {fps, fps_per_w, ...}}}"""
    out: dict[str, dict] = {}
    for name, cfg in (accels or ACCELS).items():
        rows = {w: simulate(cfg, w) for w in workloads}
        out[name] = {
            **rows,
            "gmean": {
                "fps": _gmean(r.fps for r in rows.values()),
                "fps_per_w": _gmean(r.fps_per_w for r in rows.values()),
                "fps_per_w_mm2": _gmean(r.fps_per_w_mm2 for r in rows.values()),
            },
        }
    return out


# Paper Sec. IV-C headline ratios (geometric mean over the four CNNs).
PAPER_RATIOS = {
    ("fps", "SPOGA_10", "DEAPCNN_10"): 14.4,
    ("fps", "SPOGA_10", "HOLYLIGHT_10"): 11.1,
    ("fps_per_w", "SPOGA_10", "DEAPCNN_10"): 2.0,
    ("fps_per_w", "SPOGA_10", "HOLYLIGHT_10"): 1.3,
    ("fps_per_w_mm2", "SPOGA_1", "DEAPCNN_1"): 28.5,
    ("fps_per_w_mm2", "SPOGA_1", "HOLYLIGHT_1"): 22.2,
}


def headline_ratios(comparison=None) -> dict:
    comp = comparison or fig5_comparison()
    out = {}
    for (metric, a, b), paper in PAPER_RATIOS.items():
        ours = comp[a]["gmean"][metric] / comp[b]["gmean"][metric]
        out[f"{metric}: {a} / {b}"] = {"paper": paper, "ours": round(ours, 2)}
    return out
