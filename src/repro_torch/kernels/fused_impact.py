"""Fused analog IMPACT inference: the wrappers of the CUDA kernels in
``csrc/fused_impact.cu`` (the port of ``repro.kernels.fused_impact``'s
``fused_impact``, ``fused_impact_metered``, ``fused_impact_packed`` and
``fused_impact_packed_metered``).

All take the programmed system's own layouts: literals (B, K) int8,
nonempty (C*tc,) bool, class_i (S, sr, M) f32, and the clause cells as
clause_i (R, C, tr, tc) f32 or, for the packed kernels, as the 2-bit
operand of ``kernels.packing`` (bits (R, C, ceil(tr/4), tc) uint8 and
levels (2,) f32, with ``tr`` given).  The plain kernels return the class
currents (B, M); the metered ones also return the per-lane summed
clause-crossbar and class-crossbar column currents, each (B,).  Tensors
on the CPU go to the plain versions in ``ref``; tensors on a CUDA device
go to the kernel, or the call raises.  One wrapper call is one launch of
the kernel (its three passes on the current stream), and the wrapper
allocates the kernel's scratch.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .crossbar_mvm import check, on_cuda
from .packing import packed_rows
from .ref import (fused_impact_metered_ref, fused_impact_packed_metered_ref,
                  fused_impact_packed_ref, fused_impact_ref)

SOURCE = "fused_impact.cu"
_P, _I, _F = _build.PTR, _build.INT, _build.FLOAT
_SHAPE_ARGS = [_I] * 8 + [_F, _P]   # B, K, R, C, tr, tc, Nc, M, thresh, stream

KERNEL = _build.CudaKernel(SOURCE, "fused_impact_f32", [_P] * 7 + _SHAPE_ARGS)
KERNEL_METERED = _build.CudaKernel(
    SOURCE, "fused_impact_metered_f32", [_P] * 10 + _SHAPE_ARGS)
KERNEL_PACKED = _build.CudaKernel(
    SOURCE, "fused_impact_packed_f32", [_P] * 8 + _SHAPE_ARGS)
KERNEL_PACKED_METERED = _build.CudaKernel(
    SOURCE, "fused_impact_packed_metered_f32", [_P] * 11 + _SHAPE_ARGS)


def _operands(literals, cells, nonempty, class_i, grid, *, metered: bool):
    """Validate the kernel operands around the clause cells ``cells`` (the
    already checked clause tensors of a ``grid`` = (R, C, tr, tc)) ->
    (pointer arguments, shape arguments, the tensors that must outlive
    the launch)."""
    check(literals, "literals", torch.int8, 2)
    check(class_i, "class_i", torch.float32, 3)
    B, K = literals.shape
    R, C, tr, tc = grid
    S, sr, M = class_i.shape
    if R * tr < K:
        raise ValueError(f"the clause grid holds {R}x{tr} rows for {K} "
                         f"literals")
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
    ptrs = [literals.data_ptr(), *(t.data_ptr() for t in cells),
            ne.data_ptr(), class_i.data_ptr(),
            *(t.data_ptr() for t in scratch[1:])]
    return ptrs, (B, K, R, C, tr, tc, S * sr, M), scratch


def _packed_cells(bits, levels, tr):
    """Check the packed clause operand -> (its tensors, the grid)."""
    check(bits, "bits", torch.uint8, 4)
    check(levels, "levels", torch.float32, 1)
    R, C, tr4, tc = bits.shape
    if tr4 != packed_rows(tr) or levels.shape != (2,):
        raise ValueError(f"bits {tuple(bits.shape)} and levels "
                         f"{tuple(levels.shape)} do not pack {tr} rows a "
                         f"shard with two levels")
    return (bits, levels), (R, C, tr, tc)


def _launch(kernel, ptrs, shape, dev, thresh: float, metered: bool):
    """Allocate the outputs and launch ``kernel`` once -> the scores, or
    (scores, clause meter, class meter)."""
    B, M = shape[0], shape[-1]
    outs = [torch.empty((B, M), dtype=torch.float32, device=dev)]
    if metered:
        outs += [torch.empty((B,), dtype=torch.float32, device=dev)
                 for _ in range(2)]
    kernel(*ptrs, *(t.data_ptr() for t in outs), *shape, thresh,
           torch.cuda.current_stream().cuda_stream)
    return tuple(outs) if metered else outs[0]


def fused_impact(literals: torch.Tensor, clause_i: torch.Tensor,
                 nonempty: torch.Tensor, class_i: torch.Tensor, *,
                 thresh: float) -> torch.Tensor:
    """-> class currents (B, M) f32 (argmax = prediction)."""
    if not on_cuda(literals, clause_i, nonempty, class_i):
        return fused_impact_ref(literals, clause_i, nonempty, class_i,
                                thresh=thresh)
    check(clause_i, "clause_i", torch.float32, 4)
    ptrs, shape, _keep = _operands(literals, (clause_i,), nonempty, class_i,
                                   clause_i.shape, metered=False)
    return _launch(KERNEL, ptrs, shape, literals.device, thresh, False)


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
    check(clause_i, "clause_i", torch.float32, 4)
    ptrs, shape, _keep = _operands(literals, (clause_i,), nonempty, class_i,
                                   clause_i.shape, metered=True)
    return _launch(KERNEL_METERED, ptrs, shape, literals.device, thresh,
                   True)


def fused_impact_packed(literals: torch.Tensor, bits: torch.Tensor,
                        levels: torch.Tensor, nonempty: torch.Tensor,
                        class_i: torch.Tensor, *, thresh: float,
                        tr: int) -> torch.Tensor:
    """``fused_impact`` on the packed clause operand (``bits`` (R, C,
    ceil(tr/4), tc) uint8, ``levels`` (2,) f32, ``tr`` the unpacked rows
    of a shard) -> class currents (B, M) f32.  The kernel unpacks the
    codes into its shared-memory stages."""
    if not on_cuda(literals, bits, levels, nonempty, class_i):
        return fused_impact_packed_ref(literals, bits, levels, nonempty,
                                       class_i, thresh=thresh, tr=tr)
    cells, grid = _packed_cells(bits, levels, tr)
    ptrs, shape, _keep = _operands(literals, cells, nonempty, class_i, grid,
                                   metered=False)
    return _launch(KERNEL_PACKED, ptrs, shape, literals.device, thresh,
                   False)


def fused_impact_packed_metered(literals: torch.Tensor, bits: torch.Tensor,
                                levels: torch.Tensor, nonempty: torch.Tensor,
                                class_i: torch.Tensor, *, thresh: float,
                                tr: int,
                                ) -> tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """``fused_impact_metered`` on the packed clause operand: the clause
    meter bills the quantized column currents."""
    if not on_cuda(literals, bits, levels, nonempty, class_i):
        return fused_impact_packed_metered_ref(literals, bits, levels,
                                               nonempty, class_i,
                                               thresh=thresh, tr=tr)
    cells, grid = _packed_cells(bits, levels, tr)
    ptrs, shape, _keep = _operands(literals, cells, nonempty, class_i, grid,
                                   metered=True)
    return _launch(KERNEL_PACKED_METERED, ptrs, shape, literals.device,
                   thresh, True)
