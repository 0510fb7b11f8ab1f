"""Optical link-budget / scalability model — reproduces paper Table I.

The port's own copy of ``repro/core/photonic_model.py`` (pure Python; the
port imports nothing of the JAX package).

The paper sizes each photonic GEMM core by the classic silicon-photonic
link budget (methodology of its refs [1], [2], [12]):

    P_laser(dBm) - L_total(N, M)  >=  S_detector(DR, levels)      (dBm)

* ``L_total`` — insertion losses accumulated between laser and detector:
  a fixed part (fiber/chip coupling, modulator insertion, mux/demux,
  propagation) plus terms growing with the core's parallelism:
  an **N-linear** through-loss (every extra wavelength element adds MRR
  through-loss in series on the shared bus) and, for the square MAW/AMW
  organizations, a **10*log10(fanout)** splitting loss (optical power is
  divided over the M waveguides).

* ``S_detector`` — the minimum detectable per-channel power for 4-bit
  (16-level) analog signaling.  Shot-noise-limited reception scales the
  required power with the *square root* of the sampling bandwidth, i.e.
  **+5 dB per decade of data rate** — the fit below recovers ~5.15
  dB/decade, confirming the paper operates in the shot-noise regime.

Constants below are *calibrated* so that the solver reproduces all 15
entries of paper Table I exactly (held by tests/test_torch_photonic.py and
printed by examples/torch_photonic_sim.py).  The paper body defers its exact
loss/sensitivity numbers to ref [2] (Vatsavai, TCAD'22), so calibration
against the published table is the faithful way to recover them; each
fitted value sits inside the published range for its component class
(MRR through loss 0.01-0.1 dB, splitter excess <1 dB, APD sensitivity
around -20 dBm at GHz rates).

Organizations modeled (paper Sec. II-A / Table I):

* ``MWA``  — SPOGA's Modulation-Weighting-Aggregation DPU: M is fixed at
  16 DPUs per core; N (INT8 vector elements == OAMEs per DPU) is set by
  the budget.  Per-element loss is higher (0.058 dB) because each OAME
  inserts a modulator *and* a weighting ring in series plus the homodyne
  aggregation mux.
* ``MAW``  — HOLYLIGHT-style square core (N == M).
* ``AMW``  — DEAPCNN-style square core (N == M); aggregation-first costs
  a little extra fixed loss, hence the smaller budget.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = [
    "LinkBudget",
    "BUDGETS",
    "max_vector_length",
    "scalability_table",
    "PAPER_TABLE_I",
]

# Shot-noise-limited sensitivity slope: dB of extra power per decade of
# data rate (ideal sqrt(BW) scaling == 5.0; fitted 5.15 absorbs the mild
# TIA noise-bandwidth excess).
SENS_DB_PER_DECADE = 5.15


@dataclasses.dataclass(frozen=True)
class LinkBudget:
    """Per-organization link-budget parameters (all in dB / dBm).

    ``headroom(P, DR)`` = power left for parallelism after fixed losses
    and detector sensitivity:  P - fixed_loss - S(DR).
    ``spend(N)``        = loss charged against that headroom by an
    N-element core: ``N * elem_loss + split_coeff * log10(fanout(N))``.
    """

    name: str
    elem_loss_db: float          # dB per additional vector element (MRR through)
    split_coeff: float           # dB per decade of waveguide fanout (10 == ideal)
    fixed_minus_sens_dbm: float  # (fixed losses + detector sensitivity) lump, 1 GS/s
    square: bool                 # True: N == M (MAW/AMW); False: M fixed (MWA)
    m_fixed: int = 16            # waveguide/DPU count when not square

    def headroom(self, laser_dbm: float, datarate_gs: float) -> float:
        return (
            laser_dbm
            - self.fixed_minus_sens_dbm
            - SENS_DB_PER_DECADE * math.log10(datarate_gs)
        )

    def spend(self, n: int) -> float:
        fanout = n if self.square else 1.0  # MWA fanout folded into fixed loss
        return n * self.elem_loss_db + self.split_coeff * math.log10(max(fanout, 1.0))


# Calibrated so scalability_table() == PAPER_TABLE_I (all 15 cells).
BUDGETS = {
    # SPOGA's DPU: 2 rings in series per OAME + homodyne mux excess.
    "MWA": LinkBudget("MWA", elem_loss_db=9.0 / 155.0, split_coeff=0.0,
                      fixed_minus_sens_dbm=-4.458065, square=False, m_fixed=16),
    # HOLYLIGHT: modulation-aggregation-weighting, square N x N core.
    "MAW": LinkBudget("MAW", elem_loss_db=0.0323, split_coeff=9.28,
                      fixed_minus_sens_dbm=10.0 - 16.5475, square=True),
    # DEAPCNN: aggregation-first costs extra fixed insertion loss.
    "AMW": LinkBudget("AMW", elem_loss_db=0.0315, split_coeff=9.21,
                      fixed_minus_sens_dbm=10.0 - 15.4675, square=True),
}


def max_vector_length(
    org: str, laser_dbm: float, datarate_gs: float, *, _tol: float = 1e-9
) -> tuple[int, int]:
    """-> (N, M): largest supported vector length / dot-product lanes.

    Solves ``spend(N) == headroom`` for continuous N (monotone, bisect)
    and rounds to the nearest integer — matching the paper's rounding.
    """
    b = BUDGETS[org]
    h = b.headroom(laser_dbm, datarate_gs)
    if h <= b.spend(1):
        return (1, b.m_fixed if not b.square else 1)
    lo, hi = 1.0, 1.0
    while b.spend(int(math.ceil(hi))) < h and hi < 1e6:
        lo, hi = hi, hi * 2
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if mid * b.elem_loss_db + b.split_coeff * math.log10(mid if b.square else 1.0) < h:
            lo = mid
        else:
            hi = mid
    n = int(round(0.5 * (lo + hi)))
    return (n, n if b.square else b.m_fixed)


def scalability_table(
    datarates=(1.0, 5.0, 10.0), mwa_powers=(1.0, 5.0, 10.0), square_power: float = 10.0
):
    """Regenerate paper Table I. -> {row_name: {DR: (N, M)}}"""
    out: dict[str, dict[float, tuple[int, int]]] = {}
    out["HOLYLIGHT [3]"] = {dr: max_vector_length("MAW", square_power, dr) for dr in datarates}
    out["DEAPCNN [9]"] = {dr: max_vector_length("AMW", square_power, dr) for dr in datarates}
    for p in mwa_powers:
        out[f"MWA ({p:g}dBm)"] = {dr: max_vector_length("MWA", p, dr) for dr in datarates}
    return out


# Ground truth from the paper (Table I): {row: {DR_GS: (N, M)}}.
PAPER_TABLE_I = {
    "HOLYLIGHT [3]": {1.0: (43, 43), 5.0: (21, 21), 10.0: (15, 15)},
    "DEAPCNN [9]": {1.0: (36, 36), 5.0: (17, 17), 10.0: (12, 12)},
    "MWA (1dBm)": {1.0: (94, 16), 5.0: (32, 16), 10.0: (5, 16)},
    "MWA (5dBm)": {1.0: (163, 16), 5.0: (101, 16), 10.0: (74, 16)},
    "MWA (10dBm)": {1.0: (249, 16), 5.0: (187, 16), 10.0: (160, 16)},
}
