"""Fused digital CoTM inference: the wrapper of ``fused_cotm_i32`` in
``csrc/digital_cotm.cu`` (the port of ``repro.kernels.fused_cotm``).

``fused_cotm(literals, include, weights, nonempty=None)`` returns the
class scores ``((viol == 0) & nonempty) @ weights`` (B, M) int32 without
writing the clause bits to device memory.  ``weights`` is (N, M), the
class-crossbar layout (W^T); ``nonempty`` defaults to ``include.any(0)``,
as in ``repro.kernels.ops``.  Tensors on the CPU go to the plain version
(``ref.fused_cotm_ref``); tensors on a CUDA device go to the kernel, or
the call raises.  One call is a memset of the scores and one device
kernel, which runs ``clause_eval``'s clause stage (its grid and load
widths, ``clause_eval.plan`` / ``widths``) and adds each tile's weighted
votes to the scores with int32 atomics; the wrapper allocates only the
scores.
"""
from __future__ import annotations

import torch

from . import _build
from .clause_eval import SOURCE, clause_operands
from .crossbar_mvm import check, on_cuda
from .ref import fused_cotm_ref

# literals, include, nonempty, weights, scores; B, K, N, M; the widths
# (lit_width, inc_width); the stream.
KERNEL = _build.CudaKernel(SOURCE, "fused_cotm_i32",
                           [_build.PTR] * 5 + [_build.INT] * 6
                           + [_build.PTR])


def fused_cotm(literals: torch.Tensor, include: torch.Tensor,
               weights: torch.Tensor,
               nonempty: torch.Tensor | None = None) -> torch.Tensor:
    """literals (B, K) int8 {0,1}, include (K, N) bool, weights (N, M)
    int32 -> scores (B, M) int32."""
    if nonempty is None:
        nonempty = include.to(torch.bool).any(dim=0)
    if not on_cuda(literals, include, weights, nonempty):
        return fused_cotm_ref(literals, include, weights, nonempty)
    (B, K, N), inc, ne, load_widths = clause_operands(literals, include,
                                                      nonempty)
    check(weights, "weights", torch.int32, 2)
    if weights.shape[0] != N:
        raise ValueError(f"weights must be ({N}, M), got "
                         f"{tuple(weights.shape)}")
    M = weights.shape[1]
    out = torch.empty((B, M), dtype=torch.int32, device=literals.device)
    KERNEL(literals.data_ptr(), inc.data_ptr(), ne.data_ptr(),
           weights.data_ptr(), out.data_ptr(), B, K, N, M, *load_widths,
           torch.cuda.current_stream().cuda_stream)
    return out
