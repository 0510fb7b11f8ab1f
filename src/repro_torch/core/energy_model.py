"""Component power/area/energy models — paper Table II + published values.

The port's own copy of ``repro/core/energy_model.py`` (pure Python).

Every constant the paper states is taken verbatim (ADC/DAC power & area vs
sampling rate, Table II).  Constants the paper defers to its refs [1], [2]
(laser wall-plug efficiency, MRR thermal tuning, TIA/BPCA analog power,
SRAM access energy, DEAS datapath energy) use typical published values,
cited inline.  ``accelerator_sim.py`` composes these into full-chip FPS /
FPS/W / FPS/W/mm2 numbers.
"""

from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------------------
# Paper Table II — data converters, indexed by sampling rate in GS/s.
# ---------------------------------------------------------------------------

ADC_TABLE = {  # rate_gs: (area_mm2, power_mw)   [paper refs 13-15]
    1.0: (0.002, 2.55),
    5.0: (0.021, 11.0),
    10.0: (0.103, 29.0),
}

DAC_TABLE = {  # rate_gs: (area_mm2, power_mw)   [paper refs 16-18]
    1.0: (0.00007, 0.12),
    5.0: (0.06, 26.0),
    10.0: (0.06, 30.0),
}


def adc(rate_gs: float) -> tuple[float, float]:
    return ADC_TABLE[rate_gs]


def dac(rate_gs: float) -> tuple[float, float]:
    return DAC_TABLE[rate_gs]


# ---------------------------------------------------------------------------
# Photonic & analog components (typical published values).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PhotonicConstants:
    laser_wallplug_eff: float = 0.10      # [Al-Qadasi APL'22] ~10% WPE DFB
    mrr_tuning_mw: float = 0.08           # thermal tuning / ring [TCAD'22]
    mrr_area_mm2: float = 0.00015         # 10 um ring + drop spacing
    laser_area_mm2: float = 0.05          # hybrid-integrated DFB die share
    tia_mw: float = 1.5                   # TIA / BPCA receiver analog power
    tia_area_mm2: float = 0.0003
    bpca_cap_bank_mw: float = 0.2         # integrate-and-dump switch bank
    splitter_area_mm2: float = 0.00005

    # Digital-electronic side (prior-work DEAS pipeline) — 28 nm class.
    sram_pj_per_byte: float = 1.0         # on-chip SRAM access [TCAD'22]
    deas_pj_per_op: float = 0.4           # 32-bit shift+add @ 28 nm
    deas_lane_area_mm2: float = 0.0005
    sram_mm2_per_kb: float = 0.0025
    deas_clock_ghz: float = 2.0           # electronic post-processing clock
    # Sustained ADC->SRAM->DEAS results per lane (Gops/s): 3-deep banked
    # SRAM + shift-add lanes at deas_clock -> ~6 G results/s/lane. Prior
    # work stalls the photonic front end beyond this (paper Sec. II-D).
    # Calibrated against the paper's Fig. 5 FPS ratios at 10 GS/s.
    post_gops_per_lane: float = 6.0

    # Shared digital infrastructure (both SPOGA and baselines).
    io_sram_pj_per_byte: float = 1.0      # operand staging buffers
    control_mw_per_core: float = 5.0      # sequencing, clocking, misc


CONST = PhotonicConstants()


def laser_wall_power_mw(laser_dbm: float, n_lasers: int,
                        eff: float = CONST.laser_wallplug_eff) -> float:
    """Electrical wall power for n lasers each emitting ``laser_dbm``."""
    p_opt_mw = 10.0 ** (laser_dbm / 10.0)
    return n_lasers * p_opt_mw / eff
