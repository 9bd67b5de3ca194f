"""Fused analog IMPACT inference: the wrappers of the CUDA kernel in
``csrc/fused_impact.cu`` (the port of ``repro.kernels.fused_impact``'s
``fused_impact`` and ``fused_impact_metered``).

Both take the programmed system's own layouts: literals (B, K) int8,
clause_i (R, C, tr, tc) f32, nonempty (C*tc,) bool, class_i (S, sr, M)
f32.  ``fused_impact`` returns the class currents (B, M);
``fused_impact_metered`` also returns the per-lane summed clause-crossbar
and class-crossbar column currents, each (B,).  Tensors on the CPU go to
the plain versions in ``ref``; tensors on a CUDA device go to the kernel,
or the call raises.  One wrapper call is one launch of the kernel (its
three passes on the current stream), and the wrapper allocates the
kernel's scratch.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .crossbar_mvm import check, on_cuda
from .ref import fused_impact_metered_ref, fused_impact_ref

SOURCE = "fused_impact.cu"
_P, _I, _F = _build.PTR, _build.INT, _build.FLOAT
_SHAPE_ARGS = [_I] * 8 + [_F, _P]   # B, K, R, C, tr, tc, Nc, M, thresh, stream

KERNEL = _build.CudaKernel(SOURCE, "fused_impact_f32", [_P] * 7 + _SHAPE_ARGS)
KERNEL_METERED = _build.CudaKernel(
    SOURCE, "fused_impact_metered_f32", [_P] * 10 + _SHAPE_ARGS)


def _operands(literals, clause_i, nonempty, class_i, *, metered: bool):
    """Validate the kernel operands -> (pointer arguments, shape arguments,
    the scratch tensors, which must outlive the launch)."""
    check(literals, "literals", torch.int8, 2)
    check(clause_i, "clause_i", torch.float32, 4)
    check(class_i, "class_i", torch.float32, 3)
    B, K = literals.shape
    R, C, tr, tc = clause_i.shape
    S, sr, M = class_i.shape
    if R * tr < K:
        raise ValueError(f"clause_i holds {R}x{tr} rows for {K} literals")
    if nonempty.shape != (C * tc,) or nonempty.dtype not in (
            torch.bool, torch.uint8):
        raise ValueError(f"nonempty must be bool ({C * tc},), got "
                         f"{nonempty.dtype} {tuple(nonempty.shape)}")
    ne = nonempty.contiguous().view(torch.uint8)
    sizes = (ctypes.c_longlong * 2)()
    _build.entry(SOURCE, "fused_impact_scratch", [_I] * 6 + [_P])(
        B, K, R, C, tr, tc, sizes)
    dev = literals.device
    # ``ne`` may be a copy: it is kept with the scratch so that every
    # pointer the launch reads belongs to a live tensor.
    scratch = [ne,
               torch.empty((sizes[0],), dtype=torch.float32, device=dev),
               torch.empty((sizes[1], B, M), dtype=torch.float64,
                           device=dev)]
    if metered:
        scratch.append(torch.empty((sizes[1], B), dtype=torch.float64,
                                   device=dev))
    ptrs = [literals.data_ptr(), clause_i.data_ptr(), ne.data_ptr(),
            class_i.data_ptr(), *(t.data_ptr() for t in scratch[1:])]
    return ptrs, (B, K, R, C, tr, tc, S * sr, M), scratch


def fused_impact(literals: torch.Tensor, clause_i: torch.Tensor,
                 nonempty: torch.Tensor, class_i: torch.Tensor, *,
                 thresh: float) -> torch.Tensor:
    """-> class currents (B, M) f32 (argmax = prediction)."""
    if not on_cuda(literals, clause_i, nonempty, class_i):
        return fused_impact_ref(literals, clause_i, nonempty, class_i,
                                thresh=thresh)
    ptrs, shape, _scratch = _operands(literals, clause_i, nonempty, class_i,
                                      metered=False)
    B, M = shape[0], shape[-1]
    scores = torch.empty((B, M), dtype=torch.float32, device=literals.device)
    KERNEL(*ptrs, scores.data_ptr(), *shape, thresh,
           torch.cuda.current_stream().cuda_stream)
    return scores


def fused_impact_metered(literals: torch.Tensor, clause_i: torch.Tensor,
                         nonempty: torch.Tensor, class_i: torch.Tensor, *,
                         thresh: float,
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (scores (B, M), per-lane clause meter (B,), per-lane class meter
    (B,)), the meters in amperes (``impact.energy.per_lane_read_energy``
    turns them into joules)."""
    if not on_cuda(literals, clause_i, nonempty, class_i):
        return fused_impact_metered_ref(literals, clause_i, nonempty,
                                        class_i, thresh=thresh)
    ptrs, shape, _scratch = _operands(literals, clause_i, nonempty, class_i,
                                      metered=True)
    B, M = shape[0], shape[-1]
    dev = literals.device
    scores = torch.empty((B, M), dtype=torch.float32, device=dev)
    meter_clause = torch.empty((B,), dtype=torch.float32, device=dev)
    meter_class = torch.empty((B,), dtype=torch.float32, device=dev)
    KERNEL_METERED(*ptrs, scores.data_ptr(), meter_clause.data_ptr(),
                   meter_class.data_ptr(), *shape, thresh,
                   torch.cuda.current_stream().cuda_stream)
    return scores, meter_clause, meter_class
