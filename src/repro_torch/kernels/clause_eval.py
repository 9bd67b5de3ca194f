"""Digital CoTM clause stage: the wrapper of ``clause_eval_i8`` in
``csrc/digital_cotm.cu`` (the port of ``repro.kernels.clause_eval``).

``clause_eval(literals, include, nonempty=None, mode="fired")`` returns
the clause outputs ``(viol == 0) & nonempty`` as (B, N) bool, or with
``mode="viol"`` the raw violation counts ``(1 - L) @ include`` as (B, N)
int32 (the partials of the sharded digital AND).  ``nonempty`` defaults
to ``include.any(0)``, as in ``repro.kernels.ops``.  Tensors on the CPU
go to the plain versions (``ref.clause_eval_ref`` / ``clause_viol_ref``);
tensors on a CUDA device go to the kernel, or the call raises.  One call
is one device kernel, which packs its own literal and include words; the
wrapper allocates only the output.

For the clause stage (shared with ``fused_cotm``), ``plan`` gives the
launch the kernel makes from the shape (the grid of 32-lane x 32-column
tiles, the K stages), and ``widths`` picks the literal and include load
widths per call.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import _build
from .crossbar_mvm import bool_bytes, byte_view, check, on_cuda
from .ref import clause_eval_ref, clause_viol_ref

SOURCE = "digital_cotm.cu"
MODES = ("fired", "viol")

_P, _I = _build.PTR, _build.INT
# literals, include, nonempty, out; B, K, N, mode; the widths
# (lit_width, inc_width); the stream.
KERNEL = _build.CudaKernel(SOURCE, "clause_eval_i8",
                           [_P] * 4 + [_I] * 6 + [_P])

# The clause stage's constants (``csrc/digital_cotm.cu``): threads a
# block, lanes and clause columns a block, K words a shared-memory stage
# and the padding of its rows.  Every block packs its 32 columns' include
# words, so fewer lanes a block repeat that work: at the quickstart's
# (256, 1568, 500) 32 lanes (128 blocks) took 0.0109 ms and 16 lanes (256
# blocks) 0.0142 on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, findings).
THREADS, LANES, COLS, STAGE_WORDS, PAD_WORDS = 512, 32, 32, 64, 4


@dataclass(frozen=True)
class Plan:
    """A block owns ``lanes`` lanes x ``cols`` clause columns and walks K
    in ``stages`` shared-memory stages of ``stage_words`` words; ``grid``
    = (column blocks, lane blocks)."""
    lanes: int
    cols: int
    stage_words: int
    stages: int
    grid: tuple[int, int]
    blocks: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(B: int, K: int, N: int) -> Plan:
    """The clause stage's launch on literals (B, K) and include (K, N): a
    block a ``LANES`` x ``COLS`` tile, K in stages of ``STAGE_WORDS``
    words."""
    gx, gy = _cdiv(N, COLS), _cdiv(B, LANES)
    return Plan(LANES, COLS, STAGE_WORDS, _cdiv(_cdiv(K, 32), STAGE_WORDS),
                (gx, gy), gx * gy)


def smem_bytes(K: int, fused: bool) -> int:
    """Shared memory of a clause-stage block: static, the packed words of
    a stage and the counts the warps sharing an output block hand over
    (``ClauseSmem``), for ``fused_cotm`` also the tile's fired bytes;
    dynamic, a stage's include tile (32 rows of ``COLS`` + 16 bytes a
    word, in whole 8-word steps)."""
    words = (LANES + COLS) * (STAGE_WORDS + PAD_WORDS)
    pairs = LANES // 16 * (COLS // 8)    # 16 x 8 output blocks a tile
    red = (THREADS // 32 // pairs - 1) * pairs * 32 * 4
    static = 4 * (words + red) + (LANES * COLS if fused else 0)
    steps = _cdiv(min(STAGE_WORDS, _cdiv(K, 32)), 8)
    return static + 32 * (COLS + 16) * 8 * steps


def widths(literals: torch.Tensor, include: torch.Tensor) -> tuple[int, int]:
    """Load widths of the contiguous operands -> (lit_width, inc_width):
    literal rows 16 bytes at a time where K and the base pointer are
    multiples of 16, include rows 4 bytes at a time where N and the base
    pointer are multiples of 4; else 1 (loads of any alignment)."""
    K, N = include.shape
    lit = 16 if K % 16 == 0 and literals.data_ptr() % 16 == 0 else 1
    inc = 4 if N % 4 == 0 and include.data_ptr() % 4 == 0 else 1
    return lit, inc


def clause_operands(literals: torch.Tensor, include: torch.Tensor,
                    nonempty: torch.Tensor):
    """Validate the clause-stage operands of the digital kernels -> (shape
    (B, K, N), include and nonempty as bytes, the load widths (lit_width,
    inc_width))."""
    check(literals, "literals", torch.int8, 2)
    B, K = literals.shape
    if include.ndim != 2 or include.shape[0] != K:
        raise ValueError(f"include must be ({K}, N), got "
                         f"{tuple(include.shape)}")
    N = include.shape[1]
    if tuple(nonempty.shape) != (N,):
        raise ValueError(f"nonempty must be ({N},), got "
                         f"{tuple(nonempty.shape)}")
    inc = bool_bytes(include, "include")
    return ((B, K, N), inc, byte_view(nonempty, "nonempty"),
            widths(literals, inc))


@_build.primitive(KERNEL)
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
    (B, K, N), inc, ne, load_widths = clause_operands(literals, include,
                                                      nonempty)
    out = torch.empty((B, N), device=literals.device,
                      dtype=torch.int32 if mode == "viol" else torch.int8)
    KERNEL(literals.data_ptr(), inc.data_ptr(), ne.data_ptr(),
           out.data_ptr(), B, K, N, MODES.index(mode), *load_widths,
           torch.cuda.current_stream().cuda_stream)
    return out if mode == "viol" else out.view(torch.bool)
