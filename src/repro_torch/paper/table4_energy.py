"""Table 4: energy / area / GOPS metrics of IMPACT (the port of
``benchmarks/table4_energy.py``).

Paper anchors: programming 139 nJ/pulse, erase 0.8 pJ/pulse, read LCS
3.2e-5 pJ / HCS 0.05 pJ, 67.99 pJ/datapoint (clause tile 500x1568),
16.22 pJ/datapoint (class tile 10x500), 5.76 pJ/column worst case,
413.6 GOPS, 24.56 TOPS/W, areas 2.477 / 0.016 mm^2.

The report batch is the first ``n_report`` (512) test digits, served in
one call at that batch: neither package's session chunks
``infer_with_report`` by its capacity.  On a card the staged session
launches ``crossbar_mvm`` and the fused one ``fused_impact_metered``.

Timings: the first row's ``us_per_call`` is ``build_system``'s wall; the
energy rows' is a session's wall per datapoint, measured on a second
call after a first call on the same batch has prepared the session's
entry (its CUDA graph, on a card).

Gates, which raise ``GateError``: the fused session's predictions equal
the staged one's, and its clause energy, class energy and TOPS/W lie
within rtol 1e-4 of the staged ones.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..impact import RuntimeSpec, build_system
from ..impact import energy as energy_mod
from ..impact.yflash import T_READ, V_READ, read_current
from .common import (Row, Trained, accuracy, emit, gate_close, gate_equal,
                     generator, timed, trained_mnist_cotm)

PAPER = {
    "program_nj_per_pulse": 139.0,
    "erase_pj_per_pulse": 0.8,
    "read_hcs_pj": 0.05,
    "read_lcs_pj": 3.2e-5,
    "clause_pj_per_datapoint": 67.99,
    "class_pj_per_datapoint": 16.22,
    "energy_per_op_pj": 5.76,
    "gops": 413.6,
    "area_clause_mm2": 2.477,
    "area_class_mm2": 0.016,
}
PAPER_TOPS_PER_W = 24.56
PAPER_MNIST_ACC = 0.963
RTOL_METERS = 1e-4      # fused against staged meters (the reference's gate)


def cell_energies(device) -> dict[str, float]:
    """Single-cell read energies (J) at HCS (2.5 uS) and LCS (1 nS), and
    the worst-case column: 2048 HCS cells, all driven (f32 currents)."""
    dev = resolve_device(device)

    def read(g: float) -> float:
        g = torch.tensor(g, dtype=torch.float32, device=dev)
        return float(V_READ * read_current(g) * T_READ)

    g_col = torch.full((2048, 1), 2.5e-6, device=dev)
    i_col = float(read_current(g_col).sum() * 1.0)
    return dict(hcs=read(2.5e-6), lcs=read(1e-9),
                column=i_col * V_READ * T_READ)


def metered(system, spec: RuntimeSpec, lits: torch.Tensor):
    """One warm-up call that prepares the entry, then the timed call ->
    (InferenceResult, host us per datapoint)."""
    session = system.compile(spec)
    session.infer_with_report(lits)
    res, us = timed(system.device, session.infer_with_report, lits)
    return res, us / lits.shape[0]


def main(*, device=None, trained: Trained | None = None, system=None,
         n_report: int = 512) -> list[Row]:
    """Table 4 on the trained MNIST CoTM (``trained``, default
    ``trained_mnist_cotm``), programmed with a generator seeded 3 unless
    ``system`` (already programmed from it) is given."""
    dev = resolve_device(device)
    cfg, params, lits, labels, sw_acc = (
        trained if trained is not None else trained_mnist_cotm(device=dev))
    t_build = 0.0
    if system is None:
        system, t_build = timed(dev, build_system, params, cfg,
                                generator(dev, 3), device=dev)
    rows = [emit("table4/program_nJ_per_pulse", t_build,
                 f"ours={energy_mod.E_PROGRAM_PULSE * 1e9:.1f};paper="
                 f"{PAPER['program_nj_per_pulse']}",
                 ours=energy_mod.E_PROGRAM_PULSE * 1e9),
            emit("table4/erase_pJ_per_pulse", 0.0,
                 f"ours={energy_mod.E_ERASE_PULSE * 1e12:.2f};paper="
                 f"{PAPER['erase_pj_per_pulse']}",
                 ours=energy_mod.E_ERASE_PULSE * 1e12)]
    cells = cell_energies(dev)
    rows += [emit("table4/read_HCS_pJ", 0.0,
                  f"ours={cells['hcs'] * 1e12:.3f};paper="
                  f"{PAPER['read_hcs_pj']}", ours=cells["hcs"] * 1e12),
             emit("table4/read_LCS_pJ", 0.0,
                  f"ours={cells['lcs'] * 1e12:.1e};paper="
                  f"{PAPER['read_lcs_pj']}", ours=cells["lcs"] * 1e12),
             emit("table4/energy_per_op_pJ_worstcase", 0.0,
                  f"ours={cells['column'] * 1e12:.2f};paper="
                  f"{PAPER['energy_per_op_pj']};note=ideal-sum; paper "
                  "measures 5.76 with parasitic sublinearity",
                  ours=cells["column"] * 1e12)]

    # The staged oracle, then the fused kernel's in-pass meters on the
    # same batch: the same joules from one pass.
    lits_r = lits[:n_report]
    n = lits_r.shape[0]
    res, dt = metered(system, RuntimeSpec(metering="staged",
                                          device=str(system.device)), lits_r)
    rep = res.report
    hw_acc = accuracy(res.predictions, labels[:n])
    rows += [
        emit("table4/clause_pJ_per_datapoint", dt,
             f"ours={rep.clause_energy_j / n * 1e12:.2f};"
             f"paper={PAPER['clause_pj_per_datapoint']}",
             ours=rep.clause_energy_j / n * 1e12),
        emit("table4/class_pJ_per_datapoint", dt,
             f"ours={rep.class_energy_j / n * 1e12:.2f};"
             f"paper={PAPER['class_pj_per_datapoint']}",
             ours=rep.class_energy_j / n * 1e12),
        emit("table4/gops", dt, f"ours={rep.gops:.1f};paper={PAPER['gops']}",
             ours=rep.gops),
        emit("table4/tops_per_w", dt,
             f"ours={rep.tops_per_w:.2f};paper={PAPER_TOPS_PER_W}",
             ours=rep.tops_per_w)]

    res_f, dt_f = metered(system, RuntimeSpec(metering="fused",
                                              device=str(system.device)),
                          lits_r)
    rep_f = res_f.report
    gate_equal("table4: fused predictions vs staged", res_f.predictions,
               res.predictions)
    for what in ("clause_energy_j", "class_energy_j", "tops_per_w"):
        gate_close(f"table4: fused {what} vs staged",
                   getattr(rep_f, what), getattr(rep, what), RTOL_METERS)
    rows += [
        emit("table4/clause_pJ_per_datapoint_fused", dt_f,
             f"ours={rep_f.clause_energy_j / n * 1e12:.2f};"
             f"staged={rep.clause_energy_j / n * 1e12:.2f};"
             f"paper={PAPER['clause_pj_per_datapoint']}",
             ours=rep_f.clause_energy_j / n * 1e12),
        emit("table4/class_pJ_per_datapoint_fused", dt_f,
             f"ours={rep_f.class_energy_j / n * 1e12:.2f};"
             f"staged={rep.class_energy_j / n * 1e12:.2f};"
             f"paper={PAPER['class_pj_per_datapoint']}",
             ours=rep_f.class_energy_j / n * 1e12),
        emit("table4/tops_per_w_fused", dt_f,
             f"ours={rep_f.tops_per_w:.2f};paper={PAPER_TOPS_PER_W}",
             ours=rep_f.tops_per_w)]

    areas = system.area_mm2()
    rows += [
        emit("table4/area_clause_mm2", 0.0,
             f"ours={areas['clause']:.3f};paper={PAPER['area_clause_mm2']}",
             ours=areas["clause"]),
        emit("table4/area_class_mm2", 0.0,
             f"ours={areas['class_']:.4f};paper={PAPER['area_class_mm2']}",
             ours=areas["class_"]),
        emit("table4/accuracy", 0.0,
             f"sw={sw_acc:.3f};hw={hw_acc:.3f};paper={PAPER_MNIST_ACC}",
             sw=sw_acc, hw=hw_acc)]
    return rows
