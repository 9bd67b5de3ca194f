"""IMPACT crossbar tiles: clause tile (Boolean mode) + class tile (analog),
the PyTorch port of ``repro.impact.tiles``.

Inputs arrive as voltages:

* clause tile rows:  literal 0 -> V_R, literal 1 -> floating 'Z' (0 V drive)
  — i.e. the multiplied operand is NOT(literal);
* class tile rows:   clause 1 -> V_R, clause 0 -> 'Z'.

The clause tile's current-sense amplifier thresholds each column at
4.1 uA; the class tile's column currents are the class-weighted sums.
"""
from __future__ import annotations

import dataclasses

import torch

from . import yflash
from .yflash import (DeviceVariation, G_HCS_BOOL, G_LCS, I_CSA_THRESHOLD,
                     read_current)


@dataclasses.dataclass
class ClauseTile:
    """K x n Boolean-mode crossbar storing TA include/exclude actions."""
    g: torch.Tensor            # (K, n) conductances (S)
    nonempty: torch.Tensor     # (n,) digital mask: clause has >=1 include

    def currents(self, literals: torch.Tensor) -> torch.Tensor:
        """(..., K) literals -> (..., n) column currents; only literal==0
        rows are driven at V_R."""
        drive = 1.0 - literals.to(torch.float32)
        return drive @ read_current(self.g)

    def clauses(self, literals: torch.Tensor, *,
                mask_empty: bool = True) -> torch.Tensor:
        """CSA decision: clause fires iff column current < 4.1 uA."""
        fired = self.currents(literals) < I_CSA_THRESHOLD
        if mask_empty:
            fired = fired & self.nonempty
        return fired


@dataclasses.dataclass
class ClassTile:
    """n x m analog-mode crossbar storing unipolar clause weights."""
    g: torch.Tensor            # (n, m) conductances (S)

    def currents(self, clauses: torch.Tensor) -> torch.Tensor:
        """(..., n) Boolean clauses -> (..., m) class column currents."""
        return clauses.to(torch.float32) @ read_current(self.g)

    def scores(self, clauses: torch.Tensor) -> torch.Tensor:
        return self.currents(clauses)

    def predict(self, clauses: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self.currents(clauses), dim=-1)


def _erased(shape, variability: bool, generator: torch.Generator | None,
            device) -> torch.Tensor:
    """Freshly erased array: HCS with mild spread, or uniform 2.5 uS on
    ideal devices (``variability=False``: no draws at all)."""
    if variability:
        return 2.5e-6 * torch.exp(0.05 * torch.randn(
            shape, generator=generator, device=device))
    return torch.full(shape, 2.5e-6, device=device)


# ---------------------------------------------------------------------------
# Encoding (Figs. 9-10): TA actions -> Boolean conductances
# ---------------------------------------------------------------------------

def n_unconverged(g: torch.Tensor, target_lo: torch.Tensor,
                  target_hi: torch.Tensor) -> int:
    """Count cells still outside [target_lo, target_hi] after a pulse loop
    (``pulse_until`` gives up silently when ``max_pulses`` runs out)."""
    return int(((g < target_lo) | (g > target_hi)).sum())


def encode_clause_tile(include: torch.Tensor,
                       generator: torch.Generator | None, *,
                       pulse_width: float = 1e-3,
                       variability: bool = True,
                       max_pulses: int = 64,
                       ) -> tuple[ClauseTile, dict]:
    """Program a clause tile from an include mask (K, n).

    All cells start erased at HCS; excluded cells are programmed to
    LCS < 1 nS with 1 ms pulses (Fig. 9d / Fig. 10); included cells are
    erased up to > 2.4 uS.  ``generator`` may be None only on ideal
    devices (``variability=False``), which draw nothing.
    """
    K, n = include.shape
    dev = include.device
    var = (DeviceVariation.sample(generator, (K, n)) if variability
           else DeviceVariation.none((K, n), device=dev))
    g0 = _erased((K, n), variability, generator, dev)

    target_lo = torch.where(include, G_HCS_BOOL, 0.0)
    target_hi = torch.where(include, float("inf"), G_LCS)
    g, n_prog, n_erase = yflash.pulse_until(
        g0, target_lo=target_lo, target_hi=target_hi,
        width_prog=pulse_width, width_erase=pulse_width,
        var=var, generator=generator, max_pulses=max_pulses, c2c=variability)

    stats = dict(prog_pulses=n_prog, erase_pulses=n_erase,
                 include_fraction=float(include.float().mean()),
                 pulse_width=pulse_width,
                 n_unconverged=n_unconverged(g, target_lo, target_hi))
    return ClauseTile(g=g, nonempty=include.any(dim=0)), stats


# ---------------------------------------------------------------------------
# Weight mapping (Figs. 6, 11-12): two-phase analog tuning
# ---------------------------------------------------------------------------

def weight_targets(weights_unipolar: torch.Tensor, w_max: int) -> torch.Tensor:
    """Divide [G_RANGE_LO, G_RANGE_HI] into w_max uniform segments and map
    each integer weight to its segment conductance (Fig. 6/11)."""
    frac = weights_unipolar.to(torch.float32) / max(int(w_max), 1)
    return yflash.G_RANGE_LO + frac * (yflash.G_RANGE_HI - yflash.G_RANGE_LO)


def encode_class_tile(weights_unipolar: torch.Tensor,
                      generator: torch.Generator | None, *,
                      w_max: int | None = None,
                      pretune_tol_segments: float = 20.0,
                      finetune_tol_segments: float = 5.0,
                      pretune_width: float = 500e-6,
                      finetune_width: float = 50e-6,
                      variability: bool = True,
                      finetune: bool = True,
                      adaptive: bool = False,
                      max_pulses: int = 96,
                      ) -> tuple[ClassTile, dict]:
    """Program the class tile from unipolar integer weights (n, m).

    Pre-tune: 500 us pulses to within +/-20 segments of target;
    fine-tune: 50 us pulses to within +/-5 segments (Figs. 6, 12, 13).

    ``adaptive=True`` (beyond the paper) replaces the fixed two-phase
    schedule with the closed-loop width-selecting programmer
    (``yflash.tune_adaptive``) driving straight to the fine tolerance.
    """
    n, m = weights_unipolar.shape
    dev = weights_unipolar.device
    if w_max is None:
        w_max = int(weights_unipolar.max())
    seg = (yflash.G_RANGE_HI - yflash.G_RANGE_LO) / max(w_max, 1)
    target = weight_targets(weights_unipolar, w_max)

    var = (DeviceVariation.sample(generator, (n, m)) if variability
           else DeviceVariation.none((n, m), device=dev))
    g0 = _erased((n, m), variability, generator, dev)

    if adaptive:
        tol = finetune_tol_segments * seg
        g2, p_a, e_a = yflash.tune_adaptive(
            g0, target, tol, var=var, generator=generator,
            max_pulses=max_pulses, c2c=variability)
        stats = dict(pretune_prog=p_a, pretune_erase=e_a,
                     segment_size=seg, w_max=w_max, adaptive=True,
                     n_unconverged=int((torch.abs(g2 - target) > tol).sum()))
        return ClassTile(g=g2), stats

    tol_pre = pretune_tol_segments * seg
    g1, p_pre, e_pre = yflash.pulse_until(
        g0, target_lo=target - tol_pre, target_hi=target + tol_pre,
        width_prog=pretune_width, width_erase=pretune_width,
        var=var, generator=generator, max_pulses=max_pulses,
        c2c=variability)

    stats = dict(pretune_prog=p_pre, pretune_erase=e_pre,
                 segment_size=seg, w_max=w_max)
    if finetune:
        tol_fine = finetune_tol_segments * seg
        g2, p_f, e_f = yflash.pulse_until(
            g1, target_lo=target - tol_fine, target_hi=target + tol_fine,
            width_prog=finetune_width, width_erase=finetune_width,
            var=var, generator=generator, max_pulses=max_pulses,
            c2c=variability)
        stats.update(finetune_prog=p_f, finetune_erase=e_f,
                     n_unconverged=n_unconverged(
                         g2, target - tol_fine, target + tol_fine))
    else:
        g2 = g1
        stats["n_unconverged"] = n_unconverged(
            g2, target - tol_pre, target + tol_pre)
    return ClassTile(g=g2), stats
