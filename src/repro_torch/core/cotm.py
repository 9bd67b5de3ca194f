"""Coalesced Tsetlin Machine (CoTM) — the inference subset of
``repro.core.cotm`` in PyTorch.

    include_kj = ta_state_kj > n_states            # TA action
    viol_bj    = sum_k (1 - L_bk) * include_kj     # "interaction current"
    clause_bj  = (viol_bj == 0)                    # CSA threshold
    scores_bi  = sum_j W_ij * clause_bj            # class crossbar column sum
    pred_b     = argmax_i scores_bi

These digital functions are the golden reference the analog crossbar
path is held to on ideal devices.  The integer dots run as float64
matmuls (CUDA has no integer matmul): every term is an integer far below
2**53, so the counts are exact.  Training comes with a later slice.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class CoTMConfig:
    n_literals: int          # K (features *including* negations)
    n_clauses: int           # n
    n_classes: int           # m
    n_states: int = 128      # N: per-action state count (states span [1, 2N])
    threshold: int = 32      # T: vote clamp used by training feedback
    specificity: float = 5.0  # s
    boost_true_positive: bool = True

    def init(self, generator: torch.Generator) -> "CoTMParams":
        """TAs start uniformly at the exclude/include boundary (N or N+1);
        weights start at zero."""
        dev = generator.device
        bits = torch.randint(0, 2, (self.n_literals, self.n_clauses),
                             generator=generator, device=dev)
        ta = (self.n_states + bits).to(torch.int32)
        w = torch.zeros((self.n_classes, self.n_clauses), dtype=torch.int32,
                        device=dev)
        return CoTMParams(ta_state=ta, weights=w)


@dataclasses.dataclass
class CoTMParams:
    ta_state: torch.Tensor   # (K, n) int32 in [1, 2N]
    weights: torch.Tensor    # (m, n) int32 signed

    def to(self, device) -> "CoTMParams":
        return CoTMParams(ta_state=self.ta_state.to(device),
                          weights=self.weights.to(device))


def include_mask(ta_state: torch.Tensor, n_states: int) -> torch.Tensor:
    """TA action: include iff the state sits in the upper half."""
    return ta_state > n_states


def violation_counts(literals: torch.Tensor,
                     include: torch.Tensor) -> torch.Tensor:
    """(..., K) {0,1} literals x (K, n) include -> (..., n) int32 counts of
    (literal==0, include) pairs: the clause crossbar's column current."""
    not_l = 1.0 - literals.to(torch.float64)
    return (not_l @ include.to(torch.float64)).to(torch.int32)


def clause_outputs(literals: torch.Tensor, include: torch.Tensor, *,
                   training: bool = False) -> torch.Tensor:
    """Boolean clause outputs (..., n).  At inference "empty" clauses (no
    include) are forced to 0 so untrained clauses do not vote."""
    fired = violation_counts(literals, include) == 0
    if not training:
        fired = fired & include.any(dim=0)
    return fired


def class_scores(clauses: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted votes: (..., n) x (m, n) -> (..., m) int32."""
    return (clauses.to(torch.float64)
            @ weights.to(torch.float64).T).to(torch.int32)


def forward(params: CoTMParams, literals: torch.Tensor, cfg: CoTMConfig,
            *, training: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (clauses (..., n) bool, scores (..., m) int32)."""
    inc = include_mask(params.ta_state, cfg.n_states)
    clauses = clause_outputs(literals, inc, training=training)
    return clauses, class_scores(clauses, params.weights)


def predict(params: CoTMParams, literals: torch.Tensor,
            cfg: CoTMConfig) -> torch.Tensor:
    _, scores = forward(params, literals, cfg)
    return torch.argmax(scores, dim=-1)


def to_unipolar(weights: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Paper's signed->unsigned shift: W' = W + |W_min| (argmax preserving).
    Returns (unipolar weights, the scalar shift that was added)."""
    shift = torch.clamp(-weights.min(), min=0)
    return weights + shift, shift
