"""The work of each primitive from its shapes: operations, bytes and the
device launches of its kernel, priced against the published peaks of one
NVIDIA H100 SXM at 700 W.

One function per primitive returns ``(flops, bytes)``: the operations it
must do and the bytes it must move, each input byte read once and each
output byte written once, whatever the kernel reads again.  The fused
functions' work depends on the data: only nonempty clause columns can
fire, so the scores need their cells and class rows alone, and the
clause meter also needs every column that draws current.
``needed_columns`` counts both on a system's operands; without them the
functions count every column.  ``chip_smoke.py``'s bounds and the
session's ``cost_analysis`` (and so ``impact.costmodel``) read the same
counts.

``launches_*`` give the device kernels a call runs on the ``"cuda"``
backend, from the wrappers' own plans.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass

import torch

# The modules, not the wrapper functions that ``kernels`` re-exports.
_mvm = importlib.import_module(".crossbar_mvm", __package__)
_fused = importlib.import_module(".fused_impact", __package__)

# Published peaks of one NVIDIA H100 SXM at 700 W (NVIDIA's data sheet):
# f32 outside the tensor cores (the analog kernels' FFMA), int8 on the
# tensor cores, dense (the digital kernels' exact 0/1 counts), and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12
#: Streaming multiprocessors of an H100 SXM: the SM count the launch
#: plans are priced for where no card is at hand.
H100_SMS = 132

F32, I32 = 4, 4


def bound_s(bytes_moved: float, ops: float,
            peak: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over ``peak`` -> (seconds,
    ``"bytes"`` or ``"operations"``)."""
    t_b = bytes_moved / PEAK_HBM_BYTES
    t_o = ops / peak
    return (t_o, "operations") if t_o >= t_b else (t_b, "bytes")


@dataclass(frozen=True)
class Item:
    """The work of one primitive call: ``kernel`` is the C entry it
    launches on ``"cuda"`` (or the aten pass it is), ``launches`` its
    device kernels there, ``peak`` the rate of its arithmetic."""
    kernel: str
    flops: float
    bytes: float
    launches: int
    peak: float = PEAK_F32_FLOPS

    @property
    def bound_s(self) -> float:
        """The least time an H100 could take for it (``bound_s``)."""
        return bound_s(self.bytes, self.flops, self.peak)[0]


def needed_columns(nonempty: torch.Tensor, drawing: torch.Tensor,
                   ) -> tuple[int, int]:
    """The clause columns a fused function needs on this data: only
    nonempty columns can fire, so the scores need their cells and class
    rows alone; the clause meter also needs every column that draws
    current (the leaking padding columns, not the pruned ones, which hold
    no device).  -> (for the scores, for the metered kernel)."""
    return int(nonempty.sum()), int((drawing | nonempty).sum())


def live_rows(K: int, R: int, tr: int) -> list[int]:
    """Driven rows of each of the R row shards of ``tr`` rows: rows past
    K float at 0 V and are neither read nor counted."""
    return [max(0, min(tr, K - r * tr)) for r in range(R)]


def fused_impact(B: int, K: int, R: int, tr: int, N: int, Nc: int, M: int,
                 *, metered: bool = False, packed: bool = False,
                 needed: tuple[int, int] | None = None,
                 ) -> tuple[float, float]:
    """``fused_impact`` and its metered and packed twins on literals
    (B, K), a clause grid of R shards of ``tr`` rows and N = C*tc
    columns, Nc class rows and M classes: the column currents of the
    driven rows over the needed columns (f32 cells, or 2-bit codes four
    to a byte with their two f32 levels), the nonempty mask, the class
    rows of the nonempty columns, the scores and, metered, two f32 meters
    a lane.  The paired pass 1 (``fused_impact.pairs``) reads every live
    row but multiplies K/2 a lane, one of each pair.  ``needed`` is
    ``needed_columns``' pair; None counts every column."""
    n_ne, n_meter = needed if needed is not None else (N, N)
    cols = n_meter if metered else n_ne
    rows = live_rows(K, R, tr)
    if packed:
        cells = sum(-(-r // 4) for r in rows) * cols + 2 * F32
    else:
        cells = sum(rows) * cols * F32
    class_rows = min(n_ne, Nc)
    multiplied = K // 2 if _fused.pairs(K, tr, packed) else sum(rows)
    flops = 2.0 * B * multiplied * cols + 2.0 * B * class_rows * M
    moved = (B * K + cells + N + class_rows * M * F32
             + (B * M + (2 * B if metered else 0)) * F32)
    return flops, float(moved)


def crossbar_mvm(B: int, K: int, N: int) -> tuple[float, float]:
    """``crossbar_mvm``: drive (B, K) f32 @ g (K, N) f32 -> (B, N) f32."""
    return 2.0 * B * K * N, float((B * K + K * N + B * N) * F32)


def dequant_clause(R: int, C: int, tr: int, tc: int) -> tuple[float, float]:
    """The staged path's dequantize of a 2-bit packed clause operand:
    the codes and the two levels in, the f32 cells out."""
    return 0.0, float(R * C * -(-tr // 4) * tc + 2 * F32
                      + R * C * tr * tc * F32)


def ta_feedback(rows: int, K: int, n: int) -> tuple[float, float]:
    """``ta_feedback`` on 2B = ``rows``: three 0/1 products of (K, 2B) by
    (2B, n); lit2 and three masks in, hi / lo (int32) and include in,
    the int32 deltas out."""
    return (3 * 2.0 * K * n * rows,
            float(rows * K + 3 * rows * n + (2 * I32 + 1) * K * n
                  + I32 * K * n))


def clause_eval(B: int, K: int, N: int) -> tuple[float, float]:
    """``clause_eval``: literals (B, K) int8 and include (K, N) bool, the
    nonempty mask; the fired bytes out."""
    return 2.0 * B * K * N, float(B * K + K * N + N + B * N)


def class_sum(B: int, N: int, M: int) -> tuple[float, float]:
    """``class_sum``: clauses (B, N) int8 @ weights (N, M) int32."""
    return 2.0 * B * N * M, float(B * N + I32 * N * M + I32 * B * M)


def fused_cotm(B: int, K: int, N: int, M: int) -> tuple[float, float]:
    """``fused_cotm``: the clause stage and the class stage, without the
    clause bits in device memory."""
    f1, b1 = clause_eval(B, K, N)
    f2, _ = class_sum(B, N, M)
    return f1 + f2, b1 - B * N + float(I32 * N * M + I32 * B * M)


# -- device launches of one call on "cuda" -----------------------------------

def launches_fused(B: int, N: int) -> int:
    """The fused kernels: pass 1 and the tail; the tail alone with no
    clause column; nothing with no lane."""
    if B == 0:
        return 0
    return 2 if N > 0 else 1


def launches_mvm(B: int, K: int, N: int, sms: int = H100_SMS) -> int:
    """``crossbar_mvm``: the narrow path, or the tiles and, with a split
    contraction, the in-order reduce."""
    if B == 0 or N == 0:
        return 0
    p = _mvm.plan(B, K, N, sms)
    return 1 + int(p.path == _mvm.TILES and p.splits > 1)


def launches_one(*dims: int) -> int:
    """The one-launch kernels (``ta_feedback``, ``clause_eval``,
    ``class_sum``, ``fused_cotm`` after its memset): none on an empty
    axis."""
    return int(all(d > 0 for d in dims))
