"""Software CoTM: booleanization and the digital inference reference."""
from .booleanize import booleanize, n_literals, with_negations
from .cotm import (CoTMConfig, CoTMParams, class_scores, clause_outputs,
                   forward, include_mask, predict, to_unipolar,
                   violation_counts)

__all__ = [
    "CoTMConfig", "CoTMParams", "booleanize", "n_literals", "with_negations",
    "class_scores", "clause_outputs", "forward", "include_mask", "predict",
    "to_unipolar", "violation_counts",
]
