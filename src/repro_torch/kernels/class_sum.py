"""Digital CoTM class stage: the wrapper of ``class_sum_i32`` in
``csrc/digital_cotm.cu`` (the port of ``repro.kernels.class_sum``).

``class_sum(clauses, weights)`` returns ``clauses (B, N) @ weights
(N, M)`` as (B, M) int32.  Tensors on the CPU go to the plain version
(``ref.class_sum_ref``); tensors on a CUDA device go to the kernel, or
the call raises.
"""
from __future__ import annotations

import torch

from . import _build
from .crossbar_mvm import check, on_cuda
from .ref import class_sum_ref

KERNEL = _build.CudaKernel("digital_cotm.cu", "class_sum_i32",
                           [_build.PTR] * 3 + [_build.INT] * 3
                           + [_build.PTR])


def class_sum(clauses: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """clauses (B, N) int8 (or bool) {0,1}, weights (N, M) int32 -> scores
    (B, M) int32."""
    if not on_cuda(clauses, weights):
        return class_sum_ref(clauses, weights)
    if clauses.dtype == torch.bool:
        clauses = clauses.view(torch.int8)
    check(clauses, "clauses", torch.int8, 2)
    check(weights, "weights", torch.int32, 2)
    B, N = clauses.shape
    if weights.shape[0] != N:
        raise ValueError(f"weights must be ({N}, M), got "
                         f"{tuple(weights.shape)}")
    M = weights.shape[1]
    out = torch.empty((B, M), dtype=torch.int32, device=clauses.device)
    KERNEL(clauses.data_ptr(), weights.data_ptr(), out.data_ptr(), B, N, M,
           torch.cuda.current_stream().cuda_stream)
    return out
