"""PyTorch/CUDA port of the IMPACT reproduction (``repro``).

The package mirrors ``repro``'s layout (``core/``, ``data/``, ``impact/``,
``kernels/``, ``serve/``) so every module's counterpart sits at the same
path.  It imports ``torch`` and ``numpy`` only: never ``jax``, never
``repro``.  Entry points run on the CUDA card unless the caller passes
``device="cpu"``; with no card they raise instead of falling back (see
``device.resolve_device``).

TF32 is switched off at import.  The reference's crossbar dots are IEEE
f32 and its parity contract holds scores to rtol 1e-6; TF32 keeps about
three decimal digits, which would break that contract and could move a
column current across the CSA threshold.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .device import resolve_device  # noqa: E402

__all__ = ["resolve_device"]
