"""Digital CoTM clause stage: the wrapper of ``clause_eval_i8`` in
``csrc/digital_cotm.cu`` (the port of ``repro.kernels.clause_eval``).

``clause_eval(literals, include, nonempty=None, mode="fired")`` returns
the clause outputs ``(viol == 0) & nonempty`` as (B, N) bool, or with
``mode="viol"`` the raw violation counts ``(1 - L) @ include`` as (B, N)
int32 (the partials of the sharded digital AND).  ``nonempty`` defaults
to ``include.any(0)``, as in ``repro.kernels.ops``.  Tensors on the CPU
go to the plain versions (``ref.clause_eval_ref`` / ``clause_viol_ref``);
tensors on a CUDA device go to the kernel, or the call raises.
"""
from __future__ import annotations

import torch

from . import _build
from .crossbar_mvm import byte_view, check, on_cuda
from .ref import clause_eval_ref, clause_viol_ref

SOURCE = "digital_cotm.cu"
MODES = ("fired", "viol")

KERNEL = _build.CudaKernel(SOURCE, "clause_eval_i8",
                           [_build.PTR] * 5 + [_build.INT] * 4
                           + [_build.PTR])


def clause_operands(literals: torch.Tensor, include: torch.Tensor,
                    nonempty: torch.Tensor):
    """Validate the clause-stage operands of the digital kernels -> (shape
    (B, K, N), include and nonempty as bytes, the packing scratch)."""
    check(literals, "literals", torch.int8, 2)
    B, K = literals.shape
    if include.ndim != 2 or include.shape[0] != K:
        raise ValueError(f"include must be ({K}, N), got "
                         f"{tuple(include.shape)}")
    N = include.shape[1]
    if tuple(nonempty.shape) != (N,):
        raise ValueError(f"nonempty must be ({N},), got "
                         f"{tuple(nonempty.shape)}")
    words = -(-K // 32)
    scratch = torch.empty(((B + N) * words,), dtype=torch.int32,
                          device=literals.device)
    return ((B, K, N), byte_view(include, "include"),
            byte_view(nonempty, "nonempty"), scratch)


def clause_eval(literals: torch.Tensor, include: torch.Tensor,
                nonempty: torch.Tensor | None = None, *,
                mode: str = "fired") -> torch.Tensor:
    """literals (B, K) int8 {0,1}, include (K, N) bool -> fired (B, N)
    bool, or viol (B, N) int32 with ``mode="viol"``."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if nonempty is None:
        nonempty = include.to(torch.bool).any(dim=0)
    if not on_cuda(literals, include, nonempty):
        if mode == "viol":
            return clause_viol_ref(literals, include)
        return clause_eval_ref(literals, include, nonempty)
    (B, K, N), inc, ne, scratch = clause_operands(literals, include,
                                                  nonempty)
    out = torch.empty((B, N), device=literals.device,
                      dtype=torch.int32 if mode == "viol" else torch.int8)
    KERNEL(literals.data_ptr(), inc.data_ptr(), ne.data_ptr(),
           out.data_ptr(), scratch.data_ptr(), B, K, N, MODES.index(mode),
           torch.cuda.current_stream().cuda_stream)
    return out if mode == "viol" else out.view(torch.bool)
