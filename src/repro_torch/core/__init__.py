"""Software CoTM: booleanization, the digital inference reference and
training."""
from .booleanize import booleanize, n_literals, with_negations
from .cotm import (CoTMConfig, CoTMParams, class_scores, clause_outputs,
                   forward, include_mask, predict, to_unipolar,
                   violation_counts)
from .train import (FeedbackDraws, train_epochs, train_step_batch,
                    train_step_sequential)

__all__ = [
    "CoTMConfig", "CoTMParams", "booleanize", "n_literals", "with_negations",
    "class_scores", "clause_outputs", "forward", "include_mask", "predict",
    "to_unipolar", "violation_counts", "FeedbackDraws", "train_epochs",
    "train_step_batch", "train_step_sequential",
]
