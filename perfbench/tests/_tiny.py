"""A cell of the benchmark cut to a size the CPU tests hold: the
configuration's shapes shrunk to two row shards, two clause tiles and
two class shards, the traffic to a few small batches."""
import copy

from perfbench import harness


def tiny(workload: str, batch: int = 64, pool_batches: int = 3) -> dict:
    s = copy.deepcopy(harness.spec(workload))
    cfg = s["config"]
    m = cfg["n_classes"]
    cfg.update(n_literals=48, n_clauses=20, n_classes=m, max_tile_rows=32,
               max_tile_cols=16, max_class_rows=16)
    cfg["assumed"].update(include_density=0.05)
    s["traffic"].update(batch=batch, pool_batches=pool_batches)
    return s
