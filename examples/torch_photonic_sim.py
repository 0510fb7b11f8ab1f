"""Reproduce the paper's own evaluation on the port's models: Table I and Fig. 5.

    PYTHONPATH=src python examples/torch_photonic_sim.py

Prints the link-budget scalability table (15/15 cells exact vs the paper)
and the transaction-level FPS / FPS/W / FPS/W/mm2 comparison of SPOGA vs
HOLYLIGHT (MAW) and DEAPCNN (AMW) on MobileNet-V2, ShuffleNet-V2,
ResNet-50 and GoogLeNet, with the headline ratios vs the paper's Sec IV-C.
The models are pure Python (``repro_torch.core``): nothing runs on a
device.  The lines are those of ``examples/photonic_sim.py``.
"""

from repro_torch.core.accelerator_sim import ACCELS, WORKLOADS, fig5_comparison, headline_ratios
from repro_torch.core.photonic_model import PAPER_TABLE_I, scalability_table


def table1_lines() -> list[str]:
    lines = ["", "=== Table I: scalability (N x M per GEMM core) ==="]
    table = scalability_table()
    lines.append(f"{'Architecture':16s} " + "".join(
        f"| {dr:>2g} GS/s (ours) | (paper) " for dr in (1.0, 5.0, 10.0)))
    n_match = n_total = 0
    for row, cells in PAPER_TABLE_I.items():
        parts = [f"{row:16s} "]
        for dr, paper_nm in cells.items():
            ours = table[row][dr]
            ok = ours == paper_nm
            n_match += ok
            n_total += 1
            parts.append(f"| {ours[0]:>4d}x{ours[1]:<3d} {'ok ' if ok else 'XX '} "
                         f"| {paper_nm[0]:>3d}x{paper_nm[1]:<3d} ")
        lines.append("".join(parts))
    lines.append(f"Table I reproduction: {n_match}/{n_total} cells exact")
    return lines


def fig5_lines() -> list[str]:
    comp = fig5_comparison()
    lines = ["", "=== Fig. 5: system-level comparison (4 CNNs, 8 GEMM groups) ==="]
    lines.append(f"{'accel':14s} {'workload':14s} {'FPS':>12s} {'FPS/W':>10s} "
                 f"{'FPS/W/mm2':>11s} {'power W':>9s} {'area mm2':>9s}")
    for name in ACCELS:
        for w in WORKLOADS:
            r = comp[name][w]
            lines.append(
                f"{name:14s} {w:14s} {r.fps:12.1f} {r.fps_per_w:10.3f} "
                f"{r.fps_per_w_mm2:11.5f} {r.power_w:9.2f} {r.area_mm2:9.1f}")
        g = comp[name]["gmean"]
        lines.append(
            f"{name:14s} {'GMEAN':14s} {g['fps']:12.1f} {g['fps_per_w']:10.3f} "
            f"{g['fps_per_w_mm2']:11.5f}")
    lines.append("")
    lines.append("=== headline ratios vs paper Sec. IV-C ===")
    for key, vals in headline_ratios(comp).items():
        delta = 100.0 * (vals["ours"] / vals["paper"] - 1.0)
        lines.append(f"{key:45s} ours={vals['ours']:6.2f}  paper={vals['paper']:5.1f}"
                     f"  ({delta:+.0f}%)")
    return lines


def main():
    print("\n".join(table1_lines()))
    print("\n".join(fig5_lines()))


if __name__ == "__main__":
    main()
