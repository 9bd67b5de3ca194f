"""Pure-numpy oracle for CoTM inference: the ground truth for tests (a
copy of ``repro.core.ref`` so the port depends on nothing of the
reference package).

Deliberately written in the most literal transliteration of the paper's
equations (loops where that is clearest) so the vectorized PyTorch and
CUDA implementations have an independent reference.
"""
from __future__ import annotations

import numpy as np


def clause_outputs_ref(literals: np.ndarray, include: np.ndarray,
                       training: bool = False) -> np.ndarray:
    """literals (B, K) {0,1}; include (K, n) {0,1} -> clauses (B, n) {0,1}.

    C_j = AND_i (L_i OR NOT include_i); empty clauses output `training`.
    """
    B, K = literals.shape
    K2, n = include.shape
    assert K == K2
    out = np.zeros((B, n), dtype=bool)
    nonempty = include.any(axis=0)
    for b in range(B):
        for j in range(n):
            ok = True
            for i in range(K):
                if include[i, j] and not literals[b, i]:
                    ok = False
                    break
            out[b, j] = ok and (training or nonempty[j])
    return out


def violation_counts_ref(literals: np.ndarray, include: np.ndarray) -> np.ndarray:
    """The clause-crossbar column 'current': count of (L=0, include) pairs."""
    return (1 - literals.astype(np.int64)) @ include.astype(np.int64)


def class_scores_ref(clauses: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """clauses (B, n), weights (m, n) -> (B, m)."""
    return clauses.astype(np.int64) @ weights.astype(np.int64).T


def predict_ref(literals: np.ndarray, include: np.ndarray,
                weights: np.ndarray) -> np.ndarray:
    c = clause_outputs_ref(literals, include)
    return class_scores_ref(c, weights).argmax(axis=-1)
