"""Correctly rounded ``sqrt`` and ``rsqrt`` for the port's f32 math.

The reference rounds each f32 ``sqrt`` / ``rsqrt`` once from the exact
value, and the port holds several of them to it bit for bit (the 2-bit
packing's population split, AdamW's denominator) or to one device (the
norms of the LM families).  PyTorch's CPU ``torch.sqrt`` / ``torch.rsqrt``
on f32 are not correctly rounded on every host: on an AVX-512 build about
15% of uniform draws in [0, 10) come back one ulp off for ``sqrt`` and
28% for ``rsqrt``.  These functions give each device the lowering that
is exact there:

* ``sqrt_rn``: on a CUDA tensor ``torch.sqrt``, IEEE under nvcc's default
  ``-prec-sqrt=true`` (so an optimizer step over billions of parameters
  makes no f64 temporaries); elsewhere through f64, rounded once.
* ``rsqrt_rn``: through f64 on every device (CUDA's ``rsqrtf`` is 2 ulp);
  its operands are per-row statistics, so the f64 costs nothing that
  matters.

The f64 route is exact: f64 carries more than twice f32's 24 bits plus
two, so rounding its correctly rounded ``sqrt`` to f32 is the correctly
rounded f32 ``sqrt``, and ``1 / sqrt`` in f64 (two f64 roundings) lands
on the f32 grid's correct side except within 2^-28 ulp of a midpoint.
Both keep autograd: the f64 leg's gradient is rounded to the input's
dtype on the way back.
"""
from __future__ import annotations

import torch


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """``sqrt(x)`` in ``x``'s dtype, rounded once from the exact value."""
    if x.device.type == "cuda":
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(x.dtype)


def rsqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt(x)`` in ``x``'s dtype, through f64 on every device."""
    return torch.sqrt(x.double()).reciprocal().to(x.dtype)
