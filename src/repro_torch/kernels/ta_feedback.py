"""CoTM Type I/II TA feedback deltas: the wrapper of the CUDA kernel in
``csrc/ta_feedback.cu`` (the port of ``repro.kernels.fused_impact``'s
``ta_feedback``).

Takes the layouts of the reference's ``Backend.ta_feedback``: lit2 (2B, K)
int8 doubled literal rows, fired2 / sel / match (2B, n) bool feedback
masks, hi / lo (K, n) int32 per-TA draws, include (K, n) bool TA actions;
returns ta_delta (K, n) int32, bit-identical to ``ref.ta_feedback_ref``.
Tensors on the CPU go to the plain version; tensors on a CUDA device go
to the kernel, or the call raises.  One call is one device kernel, which
packs its own masks and literals; the wrapper allocates only the output.

``plan`` gives the launch the kernel makes from the shape: the grid of
128 x 32 tiles of (K, n) and the passes over 2B.  The load widths are
chosen per call from the operands' pointers and shapes (``widths``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import _build
from .crossbar_mvm import bool_bytes, byte_view, check, on_cuda
from .ref import ta_feedback_ref

_P, _I = _build.PTR, _build.INT
# lit2, sel, match, fired, hi, lo, include, out; rows, K, n; the widths
# (width, lit_width); the stream.
KERNEL = _build.CudaKernel("ta_feedback.cu", "ta_feedback_i32",
                           [_P] * 8 + [_I] * 5 + [_P])

# The kernel's constants (``csrc/ta_feedback.cu``): threads a block, the
# (K, n) tile of a block, words of 32 rows packed a shared-memory pass,
# and the columns (literals) a warp packs at once.  The tile is tall: a
# block re-reads 3 * 2B * NT mask bytes and 2B * KT literal bytes from L2
# for its 13 * KT * NT bytes of stream; 64 x 64 measured within noise of
# it and 32 x 128 slower at the trainer's shapes on an NVIDIA H100
# (PERF.md, findings).
THREADS, KT, NT, PASS_WORDS, CHUNK = 256, 128, 32, 4, 32
PAD = 8                  # words padding each packed row
# Bytes of the kernel's shared memory: the ``Packed`` struct (the words
# of a pass, three counts a column), and the raw bytes that hold a pass's
# byte tiles (three masks x NT, the literals x KT, 32 * PASS_WORDS rows,
# each row 16 bytes longer) and then the two int32 counts of every cell
# (KT rows of NT + PAD).
PACKED_BYTES = 4 * (PASS_WORDS * (KT + PAD + 3 * (NT + PAD)) + 3 * NT)
RAW_BYTES = max(32 * PASS_WORDS * (3 * (NT + 16) + KT + 16),
                2 * 4 * KT * (NT + PAD))


@dataclass(frozen=True)
class Plan:
    """A block owns ``kt`` x ``nt`` cells of (K, n); ``grid`` = (column
    blocks, row blocks); 2B is packed in ``passes`` passes of
    ``pass_words`` words of 32 rows."""
    kt: int
    nt: int
    pass_words: int
    passes: int
    grid: tuple[int, int]
    blocks: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(rows: int, K: int, n: int) -> Plan:
    """The launch of ``ta_feedback`` on 2B = ``rows``, (K, n): a block
    a ``KT`` x ``NT`` tile, 2B in passes of ``PASS_WORDS`` words."""
    gx, gy = _cdiv(n, NT), _cdiv(K, KT)
    return Plan(KT, NT, PASS_WORDS, _cdiv(_cdiv(rows, 32), PASS_WORDS),
                (gx, gy), gx * gy)


def widths(lit2: torch.Tensor, byte_ops: tuple[torch.Tensor, ...],
           words: tuple[torch.Tensor, ...]) -> tuple[int, int]:
    """Load widths of contiguous operands -> (width, lit_width): width 4
    (hi / lo / out 16 bytes a row, include and the mask tiles 4 bytes)
    where n is a multiple of 4, the int32 ``words`` (hi, lo, out) are
    16-byte aligned and the ``byte_ops`` (sel, match, fired, include)
    4-byte aligned, else 1; lit_width 16 where K and lit2's base pointer
    are multiples of 16, else 1."""
    n = words[0].shape[1]
    wide = (n % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in words)
            and all(t.data_ptr() % 4 == 0 for t in byte_ops))
    lit = lit2.shape[1] % 16 == 0 and lit2.data_ptr() % 16 == 0
    return 4 if wide else 1, 16 if lit else 1


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
    masks = [bool_bytes(t, name) for t, name in (
        (sel, "sel"), (match, "match"), (fired2, "fired2"))]
    inc = byte_view(include, "include")
    out = torch.empty((K, n), dtype=torch.int32, device=lit2.device)
    width, lit_width = widths(lit2, (*masks, inc), (hi, lo, out))
    KERNEL(lit2.data_ptr(), *(t.data_ptr() for t in masks),
           hi.data_ptr(), lo.data_ptr(), inc.data_ptr(), out.data_ptr(),
           rows, K, n, width, lit_width,
           torch.cuda.current_stream().cuda_stream)
    return out
