"""Digital CoTM class stage: the wrapper of ``class_sum_i32`` in
``csrc/digital_cotm.cu`` (the port of ``repro.kernels.class_sum``).

``class_sum(clauses, weights)`` returns ``clauses (B, N) @ weights
(N, M)`` as (B, M) int32, any int8 clause value times an int32 weight,
summed in int32.  Tensors on the CPU go to the plain version
(``ref.class_sum_ref``); tensors on a CUDA device go to the kernel, or
the call raises.  One call is one launch (a warp a lane), or none
where B or M is 0.
"""
from __future__ import annotations

import torch

from . import _build
from .crossbar_mvm import check, on_cuda
from .ref import class_sum_ref

# The kernel's block (``csrc/digital_cotm.cu``): lanes a block (a warp
# each), classes a pass and clauses a stage of the int32 weights it
# stages in shared memory (rows padded by 4 words).
CS_LANES, CS_CLASSES, CS_CLAUSES = 8, 16, 512

KERNEL = _build.CudaKernel("digital_cotm.cu", "class_sum_i32",
                           [_build.PTR] * 3 + [_build.INT] * 4
                           + [_build.PTR])


def clause_width(clauses: torch.Tensor) -> int:
    """Clause bytes the kernel reads at once from contiguous clauses (B,
    N): 4 where the base pointer and N are multiples of 4, else 1."""
    N = clauses.shape[1]
    return 4 if clauses.data_ptr() % 4 == 0 and N % 4 == 0 else 1


@_build.primitive(KERNEL)
def class_sum(clauses: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """clauses (B, N) int8 (or bool), weights (N, M) int32 -> scores
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
    if B == 0 or M == 0:
        return out
    KERNEL(clauses.data_ptr(), weights.data_ptr(), out.data_ptr(), B, N, M,
           clause_width(clauses), torch.cuda.current_stream().cuda_stream)
    return out
