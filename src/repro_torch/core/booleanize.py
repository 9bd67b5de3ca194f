"""Booleanization: raw features -> Boolean literals (original + negated),
the PyTorch port of ``repro.core.booleanize``.

Each feature is threshold-encoded into one or more bits; every bit is
paired with its negation, so K = 2 * n_bits.
"""
from __future__ import annotations

import torch


def threshold_bits(x: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """x: (..., F) -> bits (..., F * len(thresholds)) via x > t (thermometer)."""
    bits = x[..., None] > thresholds.to(x.device)  # (..., F, T)
    return bits.reshape(*x.shape[:-1], -1)


def thermometer_thresholds(n_bits: int, lo: float = 0.0,
                           hi: float = 1.0) -> torch.Tensor:
    """Evenly spaced float32 thresholds strictly inside (lo, hi)."""
    steps = torch.arange(1, n_bits + 1, dtype=torch.float32) / (n_bits + 1)
    return lo + (hi - lo) * steps


def with_negations(bits: torch.Tensor) -> torch.Tensor:
    """bits (..., B) -> literals (..., 2B): [bits, ~bits]."""
    return torch.cat([bits, ~bits], dim=-1)


def booleanize(x: torch.Tensor, *, n_bits: int = 1, lo: float = 0.0,
               hi: float = 1.0) -> torch.Tensor:
    """x (..., F) -> literals (..., 2 * F * n_bits) bool."""
    t = thermometer_thresholds(n_bits, lo, hi)
    return with_negations(threshold_bits(torch.as_tensor(x), t))


def n_literals(n_features: int, n_bits: int = 1) -> int:
    return 2 * n_features * n_bits
