"""End-to-end IMPACT system: trained CoTM -> crossbar tiles -> inference
(the PyTorch port of ``repro.impact.pipeline``).

Fig. 14 modular scaling: literals beyond one tile's rows split across R
row shards whose partial clause bits AND digitally; clauses beyond one
tile's columns split across C column tiles; clauses beyond the class
tile's rows split across S class shards whose partial currents are
digitised and summed.

``build_system`` programs the tiles on a device and converts
conductances to per-cell read currents ONCE (``yflash.read_current``
hoisted out of the per-call path).  ``IMPACTSystem.compile(RuntimeSpec)``
resolves a runtime into an ``InferenceSession`` (see ``impact.runtime``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.cotm import CoTMConfig, CoTMParams, include_mask, to_unipolar
from ..device import resolve_device
from ..kernels.ref import pad_to
from . import energy as energy_mod
from .energy import EnergyReport
from .tiles import encode_class_tile, encode_clause_tile
from .yflash import read_current


@dataclasses.dataclass(frozen=True)
class IMPACTConfig:
    max_tile_rows: int = 2048     # clause-tile rows (literals)
    max_tile_cols: int = 512      # clause-tile columns (clauses)
    max_class_rows: int = 2048    # class-tile rows (clauses)
    variability: bool = True
    finetune: bool = True
    mask_empty: bool = True
    encode_pulse_width: float = 1e-3


@dataclasses.dataclass
class IMPACTSystem:
    """Programmed crossbar grid + digital periphery, as tensors on one
    device."""
    clause_g: torch.Tensor        # (R, C, tr, tc) conductances
    nonempty: torch.Tensor        # (C*tc,) digital empty-clause mask
    class_g: torch.Tensor         # (S, sr, m) conductances
    clause_i: torch.Tensor        # (R, C, tr, tc) per-cell read currents
    class_i: torch.Tensor         # (S, sr, m) per-cell read currents
    n_literals: int
    n_clauses: int
    n_classes: int
    cfg: IMPACTConfig
    encode_stats: dict[str, Any]
    _sessions: dict = dataclasses.field(default_factory=dict, repr=False,
                                        compare=False)

    @property
    def device(self) -> torch.device:
        return self.clause_i.device

    def _nonempty_eff(self) -> torch.Tensor:
        if self.cfg.mask_empty:
            return self.nonempty
        return torch.ones_like(self.nonempty)

    def compile(self, spec=None):
        """Resolve a ``RuntimeSpec`` ONCE into an ``InferenceSession``,
        cached per spec (the default spec runs the ``"cuda"`` backend on
        the ``cuda`` device with staged metering)."""
        from . import runtime as rt
        spec = rt.RuntimeSpec() if spec is None else spec
        if spec not in self._sessions:
            self._sessions[spec] = rt.InferenceSession(self, spec)
        return self._sessions[spec]

    def _grid_latency(self) -> float:
        """Fig. 14 latency of one sweep: all n_clauses columns stream
        through the grid's C parallel column tiles (R cancels)."""
        C = self.clause_g.shape[1]
        return energy_mod.inference_latency(
            n_clause_cols=self.n_clauses, n_class_cols=self.n_classes,
            clause_tiles_parallel=C)

    def step_report(self, e_clause_lanes, e_class_lanes,
                    datapoints: int) -> EnergyReport:
        """Fold one step's per-lane read energies into the paper's
        batch-level ``EnergyReport`` (float64 host sums, so per-request
        bills add up to the batch meter)."""
        return energy_mod.report_from_lane_energies(
            e_clause_lanes, e_class_lanes,
            program_energy_j=self.encode_stats["program_energy_j"],
            erase_energy_j=self.encode_stats["erase_energy_j"],
            latency_s=self._grid_latency(),
            ops_per_datapoint=(self.n_literals * self.n_clauses
                               + self.n_clauses * self.n_classes),
            datapoints=datapoints,
            area_mm2=sum(self.area_mm2().values()))

    def area_mm2(self) -> dict[str, float]:
        # Paper convention (Table 4): area of the *occupied* region.
        return dict(
            clause=energy_mod.tile_area_mm2(self.n_literals, self.n_clauses),
            class_=energy_mod.tile_area_mm2(self.n_clauses, self.n_classes),
        )


def build_system(params: CoTMParams, cfg: CoTMConfig,
                 generator: torch.Generator | None,
                 impact_cfg: IMPACTConfig = IMPACTConfig(), *,
                 device: str | torch.device | None = None) -> IMPACTSystem:
    """Map a trained CoTM onto crossbar tiles (Figs. 6, 9, 11) on
    ``device`` (default ``cuda``; raises without a card).

    ``generator`` (a ``torch.Generator`` on ``device``) drives the D2D and
    C2C draws, clause tile first, then class tile; ideal devices
    (``variability=False``) draw nothing and may pass ``None``."""
    dev = resolve_device(device)
    ic = impact_cfg
    if ic.variability:
        if generator is None:
            raise ValueError("variability=True needs a torch.Generator")
        if generator.device.type != dev.type:
            raise ValueError(f"generator lives on {generator.device}, the "
                             f"system is built on {dev}")
    ta_state = params.ta_state.to(dev)
    weights = params.weights.to(dev)
    K, n = ta_state.shape
    m = weights.shape[0]
    tr, tc, sr = ic.max_tile_rows, ic.max_tile_cols, ic.max_class_rows

    include = include_mask(ta_state, cfg.n_states)
    R = -(-K // tr)
    C = -(-n // tc)
    # Encode the whole padded array at once (cells are independent).
    inc_pad = pad_to(pad_to(include.to(torch.uint8), R * tr, 0),
                     C * tc, 1).to(torch.bool)
    clause_tile, cl_stats = encode_clause_tile(
        inc_pad, generator, pulse_width=ic.encode_pulse_width,
        variability=ic.variability)
    clause_g = clause_tile.g.reshape(R, tr, C, tc).permute(0, 2, 1, 3)
    clause_g = clause_g.contiguous()

    # Class crossbar: signed -> unipolar shift, then two-phase tuning.
    w_uni, shift = to_unipolar(weights)                   # (m, n)
    S = -(-n // sr)
    w_pad = pad_to(w_uni.T, S * sr, 0)
    class_tile, w_stats = encode_class_tile(
        w_pad, generator, variability=ic.variability, finetune=ic.finetune)
    class_g = class_tile.g.reshape(S, sr, m).contiguous()

    e_prog_cl, e_er_cl = energy_mod.encode_energy(
        cl_stats["prog_pulses"], cl_stats["erase_pulses"],
        ic.encode_pulse_width, ic.encode_pulse_width)
    e_prog_w, e_er_w = energy_mod.encode_energy(
        w_stats["pretune_prog"], w_stats["pretune_erase"], 500e-6, 500e-6)
    if ic.finetune:
        e_fp, e_fe = energy_mod.encode_energy(
            w_stats["finetune_prog"], w_stats["finetune_erase"], 50e-6,
            50e-6)
        e_prog_w += e_fp
        e_er_w += e_fe

    stats = dict(clause=cl_stats, weights=w_stats,
                 weight_shift=int(shift),
                 program_energy_j=e_prog_cl + e_prog_w,
                 erase_energy_j=e_er_cl + e_er_w)
    nonempty = pad_to(include.any(dim=0).to(torch.uint8), C * tc, 0)
    return IMPACTSystem(
        clause_g=clause_g, nonempty=nonempty.to(torch.bool), class_g=class_g,
        clause_i=read_current(clause_g), class_i=read_current(class_g),
        n_literals=K, n_clauses=n, n_classes=m, cfg=ic, encode_stats=stats)
