"""Online in-memory training of a deployed IMPACT system, and clause
pruning of a programmed one."""
from .compression import PruneStats, prune_clauses
from .online import OnlineTrainer

__all__ = ["OnlineTrainer", "PruneStats", "prune_clauses"]
