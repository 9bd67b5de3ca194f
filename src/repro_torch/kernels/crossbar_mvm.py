"""Analog crossbar matrix-vector product: the wrapper of the CUDA kernel in
``csrc/crossbar_mvm.cu`` (the port of ``repro.kernels.crossbar_mvm``).

``crossbar_mvm(drive, g)`` returns ``drive @ (g * v_read * nl(g))`` with
the Y-Flash low-conductance read nonlinearity.  Tensors on the CPU go to
the plain version (``ref.crossbar_mvm_ref``); tensors on a CUDA device go
to the kernel, or the call raises.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import crossbar_mvm_ref

KERNEL = _build.CudaKernel(
    "crossbar_mvm.cu", "crossbar_mvm_f32",
    [_build.PTR] * 4 + [_build.INT] * 3 + [_build.FLOAT] * 3 + [_build.PTR])


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the current CUDA device, False when
    every one lies on the CPU; raises on anything else."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        cur = torch.cuda.current_device()
        if any(t.device.index != cur for t in tensors):
            raise ValueError("kernel operands must lie on the current CUDA "
                             f"device (cuda:{cur})")
        return True
    raise ValueError(f"kernel operands must all lie on the CPU or all on "
                     f"one CUDA device, got {sorted(kinds)}")


def check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Raise unless ``t`` has the kernel's dtype, rank and a contiguous
    layout."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def byte_view(t: torch.Tensor, name: str) -> torch.Tensor:
    """A bool / int8 / uint8 operand as contiguous bytes (a view when it
    is contiguous already)."""
    if t.dtype not in (torch.bool, torch.int8, torch.uint8):
        raise TypeError(f"{name} must be bool, int8 or uint8, got {t.dtype}")
    return t.contiguous().view(torch.uint8)


def crossbar_mvm(drive: torch.Tensor, g: torch.Tensor, *,
                 v_read: float = 2.0, nonlin: float = 1.5,
                 cutoff: float = 10e-9) -> torch.Tensor:
    """drive (B, K) f32 row voltages (in V_R units), g (K, N) f32
    conductances -> column currents (B, N) f32."""
    if not on_cuda(drive, g):
        return crossbar_mvm_ref(drive, g, v_read=v_read, nonlin=nonlin,
                                cutoff=cutoff)
    check(drive, "drive", torch.float32, 2)
    check(g, "g", torch.float32, 2)
    B, K = drive.shape
    K2, N = g.shape
    if K != K2:
        raise ValueError(f"drive has {K} rows to drive, g has {K2}")
    out = torch.empty((B, N), dtype=torch.float32, device=drive.device)
    splits = _build.entry("crossbar_mvm.cu", "crossbar_mvm_splits",
                          [_build.INT] * 3, _build.INT)(B, K, N)
    scratch = (torch.empty((splits, B, N), dtype=torch.float32,
                           device=drive.device) if splits > 1 else None)
    KERNEL(drive.data_ptr(), g.data_ptr(), out.data_ptr(),
           None if scratch is None else scratch.data_ptr(), B, K, N,
           v_read, nonlin, cutoff, torch.cuda.current_stream().cuda_stream)
    return out
