"""Device resolution for every entry point of the port.

The default device is ``cuda``.  A call that did not ask for the CPU and
finds no CUDA device raises: the port never falls back to the CPU on its
own, so a run that was meant for the card cannot quietly measure the host.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the default (``cuda``).  Raises ``RuntimeError`` when
    a CUDA device is requested and none is available."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run on the CPU")
    return dev
