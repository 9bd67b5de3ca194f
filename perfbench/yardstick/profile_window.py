"""Profile windows that keep every device event, frozen.

Copied from ``src/repro_torch/analysis/profile_window.py`` at commit
9445001 (``MARGIN_S``, ``device_profile``).  ``torch.profiler`` reports
only the device events that fall inside its window, and a window that
launches its first kernel as it opens can lose the events of its first
kernels; ``device_profile`` keeps ``MARGIN_S`` of idle time at each end.
"""
from __future__ import annotations

import contextlib
import time

import torch

MARGIN_S = 0.05


@contextlib.contextmanager
def device_profile(cpu: bool = False, margin_s: float = MARGIN_S):
    """``torch.profiler.profile`` of the card's activity (and the host's
    with ``cpu``) whose window keeps ``margin_s`` of idle time before the
    body and after the body's work has finished."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        time.sleep(margin_s)
        yield prof
        torch.cuda.synchronize()
        time.sleep(margin_s)
