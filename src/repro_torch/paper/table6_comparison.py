"""Table 6: accelerator comparison (TOPS/W, TOPS/mm^2, energy ratios
against published IMC accelerators; the port of
``benchmarks/table6_comparison.py``).

The competitor numbers are fixed constants from the paper's Table 6;
ours come from the trained system's staged energy report on the first
``n_report`` (512) test digits, ``RuntimeSpec(metering="staged")`` (the
spec the reference's deprecated ``IMPACTSystem.infer_with_report`` shim
resolves to).  On a card it launches ``crossbar_mvm``.  Paper's headline
ratios: 2.23x vs ReRAM-CNN [24], 2.46x vs NOR-Flash neuromorphic [25],
0.61x vs SRAM [26], 2.06x vs PCM [27].  No row is timed.
"""
from __future__ import annotations

from ..device import resolve_device
from ..impact import RuntimeSpec, build_system
from .common import Row, Trained, emit, generator, trained_mnist_cotm

COMPETITORS = {   # name: (TOPS/W, TOPS/mm2, accuracy %, tech)
    "ref24_ReRAM_CNN": (11.014, 1.164, 96.1, "ReRAM 1T1R"),
    "ref25_NORFlash_neuromorphic": (10.0, None, 94.7, "NOR-Flash"),
    "ref26_SRAM_BCNN": (40.3, None, 98.3, "65nm SRAM"),
    "ref27_PCM_DNN": (11.9, None, 93.7, "PCM 1T1R"),
    "ref28_ReRAM_CIM": (51.4, 0.284, 91.9, "22nm ReRAM"),
    "ref29_STTMRAM": (35.2, None, 96.2, "28nm STT-MRAM"),
    "ref31_ReRAM_edge": (27.2, 0.056, 92.1, "28nm ReRAM"),
}

PAPER_OURS = {"tops_per_w": 24.56, "tops_per_mm2": 0.17}


def main(*, device=None, trained: Trained | None = None, system=None,
         n_report: int = 512) -> list[Row]:
    """Table 6 on the trained MNIST CoTM (``trained``, default
    ``trained_mnist_cotm``), programmed with a generator seeded 3 (as
    Table 4's) unless ``system`` (already programmed from it) is given."""
    dev = resolve_device(device)
    cfg, params, lits, _, _ = (
        trained if trained is not None else trained_mnist_cotm(device=dev))
    if system is None:
        system = build_system(params, cfg, generator(dev, 3), device=dev)
    report = system.compile(RuntimeSpec(
        metering="staged", device=str(system.device))).infer_with_report(
            lits[:n_report]).report
    tops_w = report.tops_per_w
    tops_mm2 = report.tops_per_mm2     # system reports carry the area
    rows = [emit("table6/ours_tops_per_w", 0.0,
                 f"ours={tops_w:.2f};paper={PAPER_OURS['tops_per_w']}",
                 ours=tops_w),
            emit("table6/ours_tops_per_mm2", 0.0,
                 f"ours={tops_mm2:.3f};paper={PAPER_OURS['tops_per_mm2']}",
                 ours=tops_mm2)]
    for name, (tw, tmm, acc, tech) in COMPETITORS.items():
        ratio = tops_w / tw
        derived = f"ratio_tops_w={ratio:.2f};their_tops_w={tw};tech={tech}"
        values = dict(ratio_tops_w=ratio)
        if tmm:
            derived += f";ratio_tops_mm2={tops_mm2 / tmm:.2f}"
            values["ratio_tops_mm2"] = tops_mm2 / tmm
        rows.append(emit(f"table6/vs_{name}", 0.0, derived, **values))
    # The paper's headline claims, for reference.
    rows.append(emit("table6/paper_claims", 0.0,
                     "2.23x_vs_ref24;2.46x_vs_ref25;0.61x_vs_ref26;"
                     "2.06x_vs_ref27"))
    return rows
