"""IMPACT energy / latency / area model — calibrated to Table 4 (PyTorch
port of ``repro.impact.energy``).

Paper anchors:
  Programming (avg)  139 nJ / pulse  (5 V x 139 uA x 200 us)
  Erasing (avg)      0.8 pJ / pulse  (8 V x 1 nA x 100 us)
  Reading LCS        3.2e-5 pJ       (2 V x ~3 nA x 5 ns, Boolean mode)
  Reading HCS        0.05 pJ         (2 V x 5 uA x 5 ns, Boolean mode)
  Energy/datapoint   67.99 pJ (clause tile, 500x1568), 16.22 pJ (class tile)
  GOPS               413.6    (op = one crosspoint interaction)
  TOPS/W             24.56    (op = MAC-equivalent: 2 per crosspoint)
  Area               3.159 um^2/device

Per-lane quantities stay tensors on the device; every host-side fold
into a report sums in float64 numpy, so per-request bills add up to the
batch meter exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .yflash import T_READ, V_READ

# Per-pulse energies (J)
E_PROGRAM_PULSE = 5.0 * 139e-6 * 200e-6     # 139 nJ
E_ERASE_PULSE = 8.0 * 1e-9 * 100e-6         # 0.8 pJ
AREA_PER_DEVICE_UM2 = 3.159
T_COLUMN = T_READ                            # one column evaluated per 5 ns


@dataclasses.dataclass
class EnergyReport:
    read_energy_j: float          # total inference read energy
    clause_energy_j: float
    class_energy_j: float
    program_energy_j: float       # one-time encode cost
    erase_energy_j: float
    latency_s: float
    ops_crosspoint: float
    datapoints: int
    area_mm2: float | None = None  # occupied crossbar area (system-level)
    #: Online-training write energy (J) billed in this report's window;
    #: serving-only reports bill exactly 0.0 here.
    write_energy_j: float = 0.0

    @property
    def energy_per_datapoint_j(self) -> float:
        return self.read_energy_j / max(self.datapoints, 1)

    @property
    def gops(self) -> float:
        if self.latency_s <= 0.0:
            return 0.0
        return (self.ops_crosspoint / max(self.datapoints, 1)) \
            / self.latency_s / 1e9

    @property
    def tops_per_w(self) -> float:
        # MAC-equivalents (2 per crosspoint op) / read energy.
        if self.read_energy_j <= 0.0:
            return 0.0
        return (2 * self.ops_crosspoint / self.read_energy_j) / 1e12

    @property
    def tops_per_mm2(self) -> float:
        if self.area_mm2 is None:
            raise ValueError(
                "tops_per_mm2 needs the crossbar area: this EnergyReport "
                "was built without area_mm2 (use IMPACTSystem reports, or "
                "set area_mm2 from IMPACTSystem.area_mm2())")
        if self.latency_s <= 0.0:
            return 0.0
        ops_per_dp = self.ops_crosspoint / max(self.datapoints, 1)
        return (2 * ops_per_dp / self.latency_s) / 1e12 / self.area_mm2


def read_energy_from_currents(currents: torch.Tensor) -> torch.Tensor:
    """E = V_R * I * t_read summed over columns — the paper's measurement."""
    return (V_READ * currents * T_READ).sum(dim=-1)


def per_lane_read_energy(i_clause_lane: torch.Tensor,
                         i_class_lane: torch.Tensor,
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Lane-summed crossbar currents (B,) -> (clause joules (B,), class
    joules (B,)); padding/invalid lanes arrive pre-masked to zero."""
    return (V_READ * i_clause_lane * T_READ,
            V_READ * i_class_lane * T_READ)


def report_from_lane_energies(e_clause_lanes, e_class_lanes,
                              **fields) -> EnergyReport:
    """Fold per-lane read energies (tensors or arrays) into a batch-level
    ``EnergyReport`` with the rest of its ``fields``
    (``IMPACTSystem.report_fields``); the lane sums are float64 on the
    host, so request attribution and the batch meter agree."""
    e_cl = float(_host_f64(e_clause_lanes).sum())
    e_cs = float(_host_f64(e_class_lanes).sum())
    return EnergyReport(read_energy_j=e_cl + e_cs, clause_energy_j=e_cl,
                        class_energy_j=e_cs, **fields)


def _host_f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def encode_energy(n_program_pulses: torch.Tensor, n_erase_pulses: torch.Tensor,
                  width_prog: float, width_erase: float) -> tuple[float, float]:
    """One-time tile-programming energy, scaled by actual pulse widths."""
    e_p = (float(n_program_pulses.sum()) * E_PROGRAM_PULSE
           * (width_prog / 200e-6))
    e_e = (float(n_erase_pulses.sum()) * E_ERASE_PULSE
           * (width_erase / 100e-6))
    return e_p, e_e


def tile_area_mm2(rows: int, cols: int) -> float:
    return rows * cols * AREA_PER_DEVICE_UM2 * 1e-6


def energy_per_effective_clause(read_energy_j: float, datapoints: int,
                                n_effective: int) -> float:
    """Table 4's read energy per datapoint per clause, re-anchored after
    clause pruning (``train.compression.prune_clauses``): the divisor is
    the count of columns still drawing current, not the programmed
    clause count.  Degenerate inputs (nothing survived, an empty
    calibration batch) report 0.0."""
    if n_effective <= 0 or datapoints <= 0:
        return 0.0
    return read_energy_j / float(datapoints) / float(n_effective)


def inference_latency(n_clause_cols: int, n_class_cols: int,
                      clause_tiles_parallel: int = 1) -> float:
    """Fig. 14 timing model: the C column tiles stream their columns
    through per-tile CSA banks in parallel (``ceil(n / C)`` 5 ns cycles);
    the class tile's columns read concurrently afterwards (one cycle)."""
    tiles = max(clause_tiles_parallel, 1)
    return -(-n_clause_cols // tiles) * T_COLUMN + T_COLUMN
