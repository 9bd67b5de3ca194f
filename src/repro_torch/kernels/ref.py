"""Plain PyTorch versions of the crossbar and digital CoTM kernels (the
port of ``repro.kernels.ref``, co-resident oracles aside).

Each hand-written CUDA kernel in this package computes the function of
the same name here.  The CPU tests hold these against the JAX oracles,
the kernel wrappers take them for tensors that lie on the CPU, and
``chip_smoke.py`` holds each kernel against them on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import packing


def clause_eval_ref(literals: torch.Tensor, include: torch.Tensor,
                    nonempty: torch.Tensor | None = None) -> torch.Tensor:
    """Boolean clause outputs: literals (B, K) {0,1}, include (K, N) {0,1}
    -> fired (B, N) bool, ``(sum_k (1-L)*inc == 0) & nonempty``.  As in
    the reference oracle, ``nonempty=None`` applies no mask (the kernel
    wrappers default it to ``include.any(0)``, as ``repro.kernels.ops``
    does)."""
    fired = clause_viol_ref(literals, include) == 0
    if nonempty is not None:
        fired = fired & nonempty.to(torch.bool)
    return fired


def clause_viol_ref(literals: torch.Tensor,
                    include: torch.Tensor) -> torch.Tensor:
    """Violation counts (the clause-crossbar column current), (B, N) int32.
    An f32 product: the counts are below K < 2**24, so it is exact (CUDA
    has no integer matmul)."""
    not_l = 1.0 - literals.to(torch.float32)
    return (not_l @ include.to(torch.float32)).to(torch.int32)


def class_sum_ref(clauses: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """clauses (B, N) int8 (any value; the paths pass {0,1}) or bool;
    weights (N, M) int -> scores (B, M) int32.  An f64 product, exact
    while |scores| < 2**53."""
    return (clauses.to(torch.float64)
            @ weights.to(torch.float64)).to(torch.int32)


def fused_cotm_ref(literals: torch.Tensor, include: torch.Tensor,
                   weights: torch.Tensor,
                   nonempty: torch.Tensor | None = None) -> torch.Tensor:
    """literals (B, K) -> class scores (B, M) int32; weights (N, M) are the
    class-crossbar layout (W^T)."""
    return class_sum_ref(clause_eval_ref(literals, include, nonempty),
                         weights)


def ta_feedback_ref(lit2: torch.Tensor, fired2: torch.Tensor,
                    sel: torch.Tensor, match: torch.Tensor, hi: torch.Tensor,
                    lo: torch.Tensor, include: torch.Tensor) -> torch.Tensor:
    """CoTM Type I/II TA feedback deltas over one doubled update batch.

    lit2 (2B, K) {0,1} literals (true-class rows, then negative-class
    rows); fired2 / sel / match (2B, n) bool feedback masks; hi / lo
    (K, n) int32 per-TA draws; include (K, n) bool current TA actions ->
    ta_delta (K, n) int32 = hi*present - lo*(absent + decay) + excl*inval
    with ``t1f = sel&match&fired``, ``present = lit^T @ t1f``, ``absent =
    (1-lit)^T @ t1f``, ``inval = (1-lit)^T @ (sel&~match&fired)`` and
    ``decay = sum_b sel&match&~fired``.  f32 products as in the
    reference: exact for counts far below 2**24.
    """
    sel, match, fired2 = (x.to(torch.bool) for x in (sel, match, fired2))
    t1 = sel & match
    t1f = (t1 & fired2).to(torch.float32)
    t1nf = (t1 & ~fired2).to(torch.float32)
    t2f = (sel & ~match & fired2).to(torch.float32)
    lit_t = lit2.to(torch.float32).T
    present = lit_t @ t1f
    absent = (1.0 - lit_t) @ t1f
    inval = (1.0 - lit_t) @ t2f
    decay = t1nf.sum(dim=0, keepdim=True)
    excl = (~include.to(torch.bool)).to(torch.float32)
    delta = (hi.to(torch.float32) * present
             - lo.to(torch.float32) * (absent + decay) + excl * inval)
    return delta.to(torch.int32)


def pad_to(x: torch.Tensor, size: int, dim: int, value=0) -> torch.Tensor:
    """Pad ``dim`` up to an absolute ``size`` (no-op when already there)."""
    pad = size - x.shape[dim]
    if pad <= 0:
        return x
    widths = [0, 0] * (x.ndim - dim % x.ndim)
    widths[-1] = pad
    return F.pad(x, widths, value=value)


def impact_clause_bits_ref(literals: torch.Tensor, clause_i: torch.Tensor,
                           nonempty: torch.Tensor, *, thresh: float,
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Analog clause stage on per-cell read currents (Fig. 14 row shards).

    literals (B, K) {0,1}; clause_i (R, C, tr, tc) f32 cell currents;
    nonempty (C*tc,) -> (fired (B, C*tc) bool, column currents
    (B, R, C, tc)).  Only literal==0 rows are driven; a column's CSA reads
    "no violation" iff its current stays below ``thresh``; shard partials
    AND digitally.
    """
    B = literals.shape[0]
    R, C, tr, tc = clause_i.shape
    lit = pad_to(literals.to(torch.float32), R * tr, 1, 1)
    drive = (1.0 - lit).reshape(B, R, tr)
    i_col = torch.einsum("brk,rckj->brcj", drive, clause_i)
    fired = torch.all(i_col < thresh, dim=1).reshape(B, C * tc)
    return fired & nonempty.to(torch.bool), i_col


def impact_class_scores_ref(clauses: torch.Tensor, class_i: torch.Tensor,
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Analog class stage: clauses (B, n) {0,1}; class_i (S, sr, M) f32
    cell currents -> (scores (B, M) summed shard currents, per-shard
    column currents (B, S, M)).  Clause columns beyond S*sr (clause-tile
    padding) are dead by construction and dropped."""
    B = clauses.shape[0]
    S, sr, M = class_i.shape
    drive = pad_to(clauses.to(torch.float32), S * sr, 1, 0)
    drive = drive[:, :S * sr].reshape(B, S, sr)
    i_col = torch.einsum("bsn,snm->bsm", drive, class_i)
    return i_col.sum(dim=1), i_col


def fused_impact_ref(literals: torch.Tensor, clause_i: torch.Tensor,
                     nonempty: torch.Tensor, class_i: torch.Tensor, *,
                     thresh: float) -> torch.Tensor:
    """Analog literals -> class currents (B, M): the clause stage, the CSA
    threshold and AND, then the class stage."""
    fired, _ = impact_clause_bits_ref(literals, clause_i, nonempty,
                                      thresh=thresh)
    scores, _ = impact_class_scores_ref(fired, class_i)
    return scores


def fused_impact_metered_ref(literals: torch.Tensor, clause_i: torch.Tensor,
                             nonempty: torch.Tensor, class_i: torch.Tensor,
                             *, thresh: float,
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """``(scores (B, M), per-lane summed clause-crossbar column currents
    (B,), per-lane summed class-crossbar column currents (B,))``.

    The clause meter sums every physical column of every row shard,
    including the columns from ``n`` up to ``C*tc``: they are real LCS
    cells drawing real leakage current."""
    fired, i_col = impact_clause_bits_ref(literals, clause_i, nonempty,
                                          thresh=thresh)
    scores, i_cls = impact_class_scores_ref(fired, class_i)
    return scores, i_col.sum(dim=(1, 2, 3)), i_cls.sum(dim=(1, 2))


def fused_impact_packed_ref(literals: torch.Tensor, bits: torch.Tensor,
                            levels: torch.Tensor, nonempty: torch.Tensor,
                            class_i: torch.Tensor, *, thresh: float,
                            tr: int) -> torch.Tensor:
    """``fused_impact_ref`` on a packed clause operand: ``bits`` (R, C,
    tr4, tc) uint8 2-bit codes, ``levels`` (2,) f32 ``[i_lcs, i_hcs]``
    (``kernels.packing``), ``tr`` the unpacked rows of a shard.
    Dequantizes, then does what the unpacked path does."""
    clause_i = packing.dequant_clause(bits, levels, tr)
    return fused_impact_ref(literals, clause_i, nonempty, class_i,
                            thresh=thresh)


def fused_impact_packed_metered_ref(literals: torch.Tensor,
                                    bits: torch.Tensor, levels: torch.Tensor,
                                    nonempty: torch.Tensor,
                                    class_i: torch.Tensor, *, thresh: float,
                                    tr: int,
                                    ) -> tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """``fused_impact_metered_ref`` on a packed clause operand: the meters
    bill the quantized currents, the ones the packed cells draw."""
    clause_i = packing.dequant_clause(bits, levels, tr)
    return fused_impact_metered_ref(literals, clause_i, nonempty, class_i,
                                    thresh=thresh)


def crossbar_mvm_ref(drive: torch.Tensor, g: torch.Tensor, *,
                     v_read: float = 2.0, nonlin: float = 1.5,
                     cutoff: float = 10e-9) -> torch.Tensor:
    """Analog crossbar column currents with the Y-Flash low-G nonlinearity:
    drive (B, K) f32 (row voltages in units of V_R), g (K, N) f32
    conductances -> (B, N) f32 = drive @ (g * V_R * nl(g))."""
    nl = torch.where(g < cutoff, nonlin, 1.0)
    return drive.to(torch.float32) @ (g * v_read * nl).to(torch.float32)
