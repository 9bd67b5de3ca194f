"""Figs. 7-8: cycle-to-cycle (C2C) and device-to-device (D2D) variability
statistics (the port of ``benchmarks/fig7_8_variability.py``).

Paper anchors: C2C over 400 cycles: LCS mean 0.925 nS (SD ~4.8%), HCS
mean 1.01 uS (SD ~9.7%); D2D over ~100 devices: LCS ~0.9 nS (SD 0.04
nS), HCS ~1.04 uS (SD 27.6 nS); programming pulse counts 23-61, erase
15-51.

Both run ``yflash.pulse_until``, whose loop tests ``done.all()`` on the
host every pulse: on a card ``c2c`` is a host-bound loop of small
launches.  ``c2c=False`` turns the per-pulse noise off (no draws), and
``var`` takes given ``DeviceVariation`` arrays, so that a caller can
drive either function deterministically.  Timings: each row's
``us_per_call`` is the function's whole wall (no warm-up).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..impact.yflash import DeviceVariation, pulse_until
from .common import Row, emit, generator, timed

# Both loops' pulse widths (s) and the LCS / HCS bands: program to below
# 1 nS, erase to above 1 uS, like the paper's setup.
W_PROG, W_ERASE = 200e-6, 100e-6
G_LCS_BAND, G_HCS_BAND = 1e-9, 1e-6


def c2c(cycles: int = 400, *, device=None, c2c: bool = True,
        var: DeviceVariation | None = None) -> tuple[np.ndarray, np.ndarray]:
    """One device, many program/erase cycles (tolerance-band controller:
    pulse until within the paper's LCS / HCS bands).  ``var`` defaults to
    no D2D variation, as the reference runs it.  (The reference also
    samples a ``DeviceVariation`` that it never uses; that draw is left
    out.)  -> (LCS conductances (cycles,), HCS conductances (cycles,))."""
    dev = resolve_device(device)
    gen = generator(dev, 0)
    var = DeviceVariation.none((1,), device=dev) if var is None else var
    g = torch.full((1,), 2.5e-6, device=dev)
    lo, hi = torch.zeros(1, device=dev), torch.full((1,), G_LCS_BAND,
                                                     device=dev)
    lo_e = torch.full((1,), G_HCS_BAND, device=dev)
    hi_e = torch.full((1,), float("inf"), device=dev)
    lcs, hcs = [], []
    for _ in range(cycles):
        g, _, _ = pulse_until(g, target_lo=lo, target_hi=hi,
                              width_prog=W_PROG, width_erase=W_ERASE,
                              var=var, generator=gen, max_pulses=128,
                              c2c=c2c)
        lcs.append(float(g[0]))
        g, _, _ = pulse_until(g, target_lo=lo_e, target_hi=hi_e,
                              width_prog=W_PROG, width_erase=W_ERASE,
                              var=var, generator=gen, max_pulses=128,
                              c2c=c2c)
        hcs.append(float(g[0]))
    return np.asarray(lcs), np.asarray(hcs)


def d2d(n_devices: int = 100, *, device=None, c2c: bool = True,
        var: DeviceVariation | None = None):
    """``n_devices`` devices with their own D2D variation (default: drawn
    from a generator seeded 3), programmed to LCS then erased to HCS ->
    (LCS conductances, program pulse counts, HCS conductances, erase pulse
    counts) as numpy arrays."""
    dev = resolve_device(device)
    n = n_devices
    if var is None:
        var = DeviceVariation.sample(generator(dev, 3), (n,))
    g_lcs, n_prog, _ = pulse_until(
        torch.full((n,), 2.5e-6, device=dev),
        target_lo=torch.zeros(n, device=dev),
        target_hi=torch.full((n,), G_LCS_BAND, device=dev),
        width_prog=W_PROG, width_erase=W_ERASE, var=var,
        generator=generator(dev, 2), max_pulses=256, c2c=c2c)
    g_hcs, _, n_er = pulse_until(
        g_lcs, target_lo=torch.full((n,), G_HCS_BAND, device=dev),
        target_hi=torch.full((n,), float("inf"), device=dev),
        width_prog=W_PROG, width_erase=W_ERASE, var=var,
        generator=generator(dev, 4), max_pulses=256, c2c=c2c)
    return tuple(t.cpu().numpy() for t in (g_lcs, n_prog, g_hcs, n_er))


def main(*, device=None, cycles: int = 60,
         n_devices: int = 100) -> list[Row]:
    """Fig. 7 at ``cycles`` (the reference's reduced 60) and Fig. 8 at
    ``n_devices``."""
    dev = resolve_device(device)
    (lcs, hcs), us = timed(dev, c2c, cycles, device=dev)
    rows = [emit("fig7/c2c_lcs", us,
                 f"mean_nS={lcs.mean() * 1e9:.3f};"
                 f"sd_pct={lcs.std() / lcs.mean() * 100:.1f};"
                 "paper_mean=0.925nS;paper_sd=4.8pct",
                 mean=float(lcs.mean()), sd=float(lcs.std())),
            emit("fig7/c2c_hcs", us,
                 f"mean_uS={hcs.mean() * 1e6:.3f};"
                 f"sd_pct={hcs.std() / hcs.mean() * 100:.1f};"
                 "paper_mean=1.01uS;paper_sd=9.74pct",
                 mean=float(hcs.mean()), sd=float(hcs.std()))]

    (g_lcs, n_prog, g_hcs, n_er), us = timed(dev, d2d, n_devices,
                                             device=dev)
    rows += [
        emit("fig8/d2d_lcs", us,
             f"mean_nS={g_lcs.mean() * 1e9:.3f};"
             f"sd_nS={g_lcs.std() * 1e9:.3f};"
             "paper_mean=0.9nS;paper_sd=0.04nS",
             mean=float(g_lcs.mean()), sd=float(g_lcs.std())),
        emit("fig8/d2d_hcs", us,
             f"mean_uS={g_hcs.mean() * 1e6:.3f};"
             f"sd_nS={g_hcs.std() * 1e9:.1f};"
             "paper_mean=1.04uS;paper_sd=27.6nS",
             mean=float(g_hcs.mean()), sd=float(g_hcs.std())),
        emit("fig8/d2d_prog_pulses", us,
             f"min={n_prog.min()};max={n_prog.max()};paper_range=23-61",
             min=int(n_prog.min()), max=int(n_prog.max())),
        emit("fig8/d2d_erase_pulses", us,
             f"min={n_er.min()};max={n_er.max()};paper_range=15-51",
             min=int(n_er.min()), max=int(n_er.max()))]
    return rows
