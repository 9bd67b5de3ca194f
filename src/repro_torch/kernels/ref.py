"""Plain PyTorch versions of the crossbar kernels (the port of
``repro.kernels.ref`` for this slice).

Each hand-written CUDA kernel in this package computes the function of
the same name here.  The CPU tests hold these against the JAX oracles,
the kernel wrappers take them for tensors that lie on the CPU, and
``chip_smoke.py`` holds each kernel against them on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


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


def crossbar_mvm_ref(drive: torch.Tensor, g: torch.Tensor, *,
                     v_read: float = 2.0, nonlin: float = 1.5,
                     cutoff: float = 10e-9) -> torch.Tensor:
    """Analog crossbar column currents with the Y-Flash low-G nonlinearity:
    drive (B, K) f32 (row voltages in units of V_R), g (K, N) f32
    conductances -> (B, N) f32 = drive @ (g * V_R * nl(g))."""
    nl = torch.where(g < cutoff, nonlin, 1.0)
    return drive.to(torch.float32) @ (g * v_read * nl).to(torch.float32)
