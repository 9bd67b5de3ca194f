"""Y-Flash memristor digital twin (PyTorch port of ``repro.impact.yflash``).

Models the 180 nm two-terminal Y-Flash device of the paper [16-18]:

* program pulses (5 V) move conductance DOWN (toward LCS) — exponential
  decay with per-device time constant;
* erase pulses (8 V) move conductance UP (toward HCS) — exponential
  approach to a ceiling;
* cycle-to-cycle (C2C) noise: per-pulse multiplicative log-normal;
* device-to-device (D2D) spread: per-device log-normal scaling of the
  program/erase time constants and of the asymptotes.

Randomness comes from an explicit ``torch.Generator`` that lives on the
same device as the conductances; draws are consumed in a fixed order, so
a seeded generator reproduces a programming run.
"""
from __future__ import annotations

import dataclasses

import torch

# --- device constants (SI units) -------------------------------------------
G_LCS = 1e-9          # Boolean low-conductance state threshold (S)
G_HCS_BOOL = 2.4e-6   # Boolean high-conductance state threshold (S)
G_MIN = 0.25e-9       # programming floor (S)
G_MAX = 3.0e-6        # erasing ceiling (S)
G_RANGE_LO = 1e-9     # analog-mode usable range (S)
G_RANGE_HI = 2.5e-6
V_READ = 2.0          # read voltage (V)
T_READ = 5e-9         # read pulse width (s)
V_PROG = 5.0
V_ERASE = 8.0
TAU_PROG = 8.96e-4    # s — gives ~7 pulses HCS->LCS at 1 ms width
TAU_ERASE = 6.2e-3    # s — gives ~25 pulses LCS->1 uS at 100 us width
I_CSA_THRESHOLD = 4.1e-6   # A — clause CSA decision boundary
LCS_NONLINEARITY = 1.5     # low-G read current boost (Fig. 5c: ~3 nA vs 2 nA)
G_NONLIN_CUTOFF = 10e-9    # S — below this the nonlinearity applies

# Variability scales (calibrated against Figs. 7-8 statistics).
C2C_SIGMA = 0.048     # per-pulse log-normal sigma (LCS SD ~4.8 %)
C2C_SIGMA_HCS = 0.097
D2D_SIGMA_TAU = 0.22  # per-device tau spread -> 23-61 pulse D2D range
D2D_SIGMA_G = 0.04


def _lognormal(sigma: float, shape, generator: torch.Generator) -> torch.Tensor:
    return torch.exp(sigma * torch.randn(shape, generator=generator,
                                         device=generator.device))


@dataclasses.dataclass(frozen=True)
class DeviceVariation:
    """Per-device (D2D) multiplicative factors, sampled once per array."""
    tau_prog: torch.Tensor   # scales the program time constant
    tau_erase: torch.Tensor
    g_floor: torch.Tensor    # scales G_MIN
    g_ceil: torch.Tensor     # scales G_MAX

    @staticmethod
    def sample(generator: torch.Generator,
               shape: tuple[int, ...]) -> "DeviceVariation":
        return DeviceVariation(
            tau_prog=_lognormal(D2D_SIGMA_TAU, shape, generator),
            tau_erase=_lognormal(D2D_SIGMA_TAU, shape, generator),
            g_floor=_lognormal(D2D_SIGMA_G, shape, generator),
            g_ceil=_lognormal(D2D_SIGMA_G, shape, generator),
        )

    @staticmethod
    def none(shape: tuple[int, ...], device=None) -> "DeviceVariation":
        one = torch.ones(shape, device=device)
        return DeviceVariation(one, one, one, one)


def _neg_over(width: float, tau: torch.Tensor) -> torch.Tensor:
    # ``-width / tau`` as a true division: Python's ``scalar / tensor``
    # goes through ``tensor.reciprocal() * scalar`` in PyTorch, which
    # rounds differently from the reference's f32 divide.
    return torch.full_like(tau, -width) / tau


# Both pulses step with one fused multiply-add (``addcmul``): the
# reference's compiled pulse loop contracts ``a + b * c`` the same way, so
# ideal-device trajectories agree bit for bit wherever ``exp`` does.


def program_pulse(g: torch.Tensor, width: float, var: DeviceVariation,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """One 5 V program pulse: exponential decay toward the floor."""
    floor = G_MIN * var.g_floor
    decay = torch.exp(_neg_over(width, TAU_PROG * var.tau_prog))
    if generator is not None:
        decay = decay * _lognormal(C2C_SIGMA, g.shape, generator)
    return torch.addcmul(floor, g - floor, torch.clamp(decay, 0.0, 1.0))


def erase_pulse(g: torch.Tensor, width: float, var: DeviceVariation,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """One 8 V erase pulse: exponential approach to the ceiling."""
    ceil = G_MAX * var.g_ceil
    rate = 1.0 - torch.exp(_neg_over(width, TAU_ERASE * var.tau_erase))
    if generator is not None:
        rate = rate * _lognormal(C2C_SIGMA_HCS, g.shape, generator)
    return torch.addcmul(g, ceil - g, torch.clamp(rate, 0.0, 1.0))


def read_current(g: torch.Tensor, v_read: float = V_READ) -> torch.Tensor:
    """I = G*V with the paper's low-conductance nonlinearity (Fig. 5c)."""
    nl = torch.where(g < G_NONLIN_CUTOFF, LCS_NONLINEARITY, 1.0)
    return g * v_read * nl


def pulse_until(g: torch.Tensor, *, target_lo: torch.Tensor,
                target_hi: torch.Tensor, width_prog: float,
                width_erase: float, var: DeviceVariation,
                generator: torch.Generator | None, max_pulses: int = 128,
                c2c: bool = True,
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Vectorised program/erase loop: drive every cell into
    [target_lo, target_hi].  Returns (G, prog_pulse_counts,
    erase_pulse_counts) with int32 counts.

    Same stopping rule as the reference's ``while_loop``: stop once every
    cell is in band or after ``max_pulses`` iterations.  ``c2c=False``
    turns off the per-pulse noise (no generator draws), making the
    trajectory a deterministic function of start and target.
    """
    n_prog = torch.zeros(g.shape, dtype=torch.int32, device=g.device)
    n_erase = torch.zeros_like(n_prog)
    gen = generator if c2c else None
    for _ in range(max_pulses):
        done = (g >= target_lo) & (g <= target_hi)
        if bool(done.all()):
            break
        too_high = g > target_hi
        too_low = g < target_lo
        g_p = program_pulse(g, width_prog, var, gen)
        g_e = erase_pulse(g, width_erase, var, gen)
        g = torch.where(too_high, g_p, torch.where(too_low, g_e, g))
        n_prog += too_high.to(torch.int32)
        n_erase += too_low.to(torch.int32)
    return g, n_prog, n_erase


def tune_adaptive(g: torch.Tensor, target: torch.Tensor, tol, *,
                  var: DeviceVariation, generator: torch.Generator | None,
                  widths: tuple[float, ...] = (500e-6, 50e-6, 5e-6),
                  max_pulses: int = 64, c2c: bool = True,
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-loop programmer with a per-cell choice of pulse width
    (beyond the paper's fixed two-phase schedule).  Returns (G,
    prog_pulse_counts, erase_pulse_counts) with int32 counts.

    Each iteration lands every candidate move deterministically (program
    and erase at each width, in that order), picks per cell the one that
    lands closest to ``target`` (the first on a tie), and applies it with
    its own C2C draw: program noise (``C2C_SIGMA``) first, then erase
    noise (``C2C_SIGMA_HCS``), each a full draw of ``g``'s shape, from
    ``generator``.  Cells within ``tol`` of ``target`` are frozen, and the
    loop stops once every cell is, or after ``max_pulses`` iterations.
    ``c2c=False`` (ideal devices) draws nothing: ``generator`` may be
    None.
    """
    n_prog = torch.zeros(g.shape, dtype=torch.int32, device=g.device)
    n_erase = torch.zeros_like(n_prog)
    width_of = torch.tensor(widths, dtype=torch.float32, device=g.device)
    floor = G_MIN * var.g_floor
    ceil = G_MAX * var.g_ceil
    for _ in range(max_pulses):
        done = torch.abs(g - target) <= tol
        if bool(done.all()):
            break
        landing = torch.stack([pulse(g, w, var) for w in widths
                               for pulse in (program_pulse, erase_pulse)])
        best = torch.argmin(torch.abs(landing - target), dim=0)
        is_prog = best % 2 == 0
        width = width_of[best // 2]
        decay = torch.exp(-width / (TAU_PROG * var.tau_prog))
        rate = 1.0 - torch.exp(-width / (TAU_ERASE * var.tau_erase))
        if c2c:
            decay = decay * _lognormal(C2C_SIGMA, g.shape, generator)
            rate = rate * _lognormal(C2C_SIGMA_HCS, g.shape, generator)
        g_prog = torch.addcmul(floor, g - floor, torch.clamp(decay, 0.0, 1.0))
        g_erase = torch.addcmul(g, ceil - g, torch.clamp(rate, 0.0, 1.0))
        g = torch.where(done, g, torch.where(is_prog, g_prog, g_erase))
        n_prog += (~done & is_prog).to(torch.int32)
        n_erase += (~done & ~is_prog).to(torch.int32)
    return g, n_prog, n_erase
