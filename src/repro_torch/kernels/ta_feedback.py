"""CoTM Type I/II TA feedback deltas: the wrapper of the CUDA kernel in
``csrc/ta_feedback.cu`` (the port of ``repro.kernels.fused_impact``'s
``ta_feedback``).

Takes the layouts of the reference's ``Backend.ta_feedback``: lit2 (2B, K)
int8 doubled literal rows, fired2 / sel / match (2B, n) bool feedback
masks, hi / lo (K, n) int32 per-TA draws, include (K, n) bool TA actions;
returns ta_delta (K, n) int32, bit-identical to ``ref.ta_feedback_ref``.
Tensors on the CPU go to the plain version; tensors on a CUDA device go
to the kernel, or the call raises.  One call is one launch (two packing
passes and the delta pass on the current stream).
"""
from __future__ import annotations

import torch

from . import _build
from .crossbar_mvm import byte_view, check, on_cuda
from .ref import ta_feedback_ref

KERNEL = _build.CudaKernel("ta_feedback.cu", "ta_feedback_i32",
                           [_build.PTR] * 9 + [_build.INT] * 3
                           + [_build.PTR])


def ta_feedback(lit2: torch.Tensor, fired2: torch.Tensor, sel: torch.Tensor,
                match: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
                include: torch.Tensor) -> torch.Tensor:
    """-> ta_delta (K, n) int32 (see ``ref.ta_feedback_ref``)."""
    ops = (lit2, fired2, sel, match, hi, lo, include)
    if not on_cuda(*ops):
        return ta_feedback_ref(*ops)
    check(lit2, "lit2", torch.int8, 2)
    check(hi, "hi", torch.int32, 2)
    check(lo, "lo", torch.int32, 2)
    rows, K = lit2.shape
    n = hi.shape[1]
    for name, t, shape in (("fired2", fired2, (rows, n)),
                           ("sel", sel, (rows, n)),
                           ("match", match, (rows, n)),
                           ("hi", hi, (K, n)), ("lo", lo, (K, n)),
                           ("include", include, (K, n))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    masks = [byte_view(t, name) for t, name in (
        (sel, "sel"), (match, "match"), (fired2, "fired2"),
        (include, "include"))]
    words = -(-rows // 32)
    scratch = torch.empty((words * (K + 3 * n),), dtype=torch.int32,
                          device=lit2.device)
    out = torch.empty((K, n), dtype=torch.int32, device=lit2.device)
    KERNEL(lit2.data_ptr(), masks[0].data_ptr(), masks[1].data_ptr(),
           masks[2].data_ptr(), hi.data_ptr(), lo.data_ptr(),
           masks[3].data_ptr(), out.data_ptr(), scratch.data_ptr(), rows, K,
           n, torch.cuda.current_stream().cuda_stream)
    return out
