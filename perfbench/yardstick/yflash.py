"""Y-Flash device constants and the read model, frozen.

Copied from ``src/repro_torch/impact/yflash.py`` (the port's Y-Flash
digital twin) at commit 9445001: the constants the deployments are drawn
with and the read current the reference works the cell currents out
with.  Only what the benchmark uses is copied.
"""
from __future__ import annotations

import torch

G_LCS = 1e-9          # Boolean low-conductance state threshold (S)
G_HCS_BOOL = 2.4e-6   # Boolean high-conductance state threshold (S)
G_MIN = 0.25e-9       # programming floor (S)
G_MAX = 3.0e-6        # erasing ceiling (S)
G_RANGE_LO = 1e-9     # analog-mode usable range (S)
G_RANGE_HI = 2.5e-6
V_READ = 2.0          # read voltage (V)
T_READ = 5e-9         # read pulse width (s)
I_CSA_THRESHOLD = 4.1e-6   # A: clause CSA decision boundary
LCS_NONLINEARITY = 1.5     # low-G read current boost (Fig. 5c)
G_NONLIN_CUTOFF = 10e-9    # S: below this the nonlinearity applies


def read_current(g: torch.Tensor, v_read: float = V_READ) -> torch.Tensor:
    """I = G*V with the paper's low-conductance nonlinearity (Fig. 5c), in
    the dtype of ``g``."""
    nl = torch.where(g < G_NONLIN_CUTOFF, LCS_NONLINEARITY, 1.0)
    return g * v_read * nl.to(g.dtype)
