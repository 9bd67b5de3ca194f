"""Training: online in-memory training of a deployed IMPACT system,
clause pruning, and LM training (optimizer, step, checkpoints, the
fault-tolerant loop, int8 gradient compression), on one device or ZeRO
on a mesh."""
from .checkpoint import CheckpointManager
from .compression import (PruneStats, compressed_grad_allreduce, int8_psum,
                          prune_clauses)
from .online import OnlineTrainer
from .optimizer import (AdamWConfig, TrainState, apply_updates, global_norm,
                        init_state, shard_state, state_shardings)
from .runtime import RuntimeConfig, SimulatedFailure, TrainLoop
from .step import ShardedStep, cast_tree, make_train_step, zero_shardings

__all__ = [
    "AdamWConfig", "TrainState", "apply_updates", "global_norm",
    "init_state", "make_train_step", "cast_tree", "CheckpointManager",
    "compressed_grad_allreduce", "int8_psum", "RuntimeConfig",
    "SimulatedFailure", "TrainLoop", "OnlineTrainer", "PruneStats",
    "prune_clauses", "ShardedStep", "shard_state", "state_shardings",
    "zero_shardings",
]
