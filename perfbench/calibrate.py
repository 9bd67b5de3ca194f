"""The readings each cell's limits are set from (``perfbench/limits/``):
the program's numbers over many seeds (the lower readings) and the
control's (the upper ones), in one process a cell.

    python3 perfbench/calibrate.py --workload <name> --seeds 12 \
        --control-seeds 3 [--base <seed>]

On a card.  For each program seed it builds the cell at its timed size
and serves every batch of its pool once through the timed path, then
holds each to the reference; for each control seed it puts the
reference's TF32 sweep in the program's place (``families.<family>.
control_output``) and holds it to the reference in the same way.  Prints
one JSON line a seed and a last line with the worst program reading and
the least control reading of each number.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import sys
import time


def program_readings(s: dict, seed: int, device) -> dict:
    """The worst reading of each number over one seed's pool, served by
    the program through the timed path."""
    import torch
    family = importlib.import_module(
        f"perfbench.families.{s['config']['family']}")
    cell = family.Cell(s["config"], s["traffic"], seed, torch.device(device))
    kept = [(i, cell.batch(i, {})[0]) for i in range(len(cell.pool))]
    dep, pool = cell.dep, cell.pool
    cell.close()
    del cell
    gc.collect()
    worst, failed = family.check(dep, pool, kept, s["limits"])
    return dict(worst, failed=failed)


def control_readings(s: dict, seed: int, device) -> dict:
    """The same with the control in the program's place."""
    import torch
    family = importlib.import_module(
        f"perfbench.families.{s['config']['family']}")
    gen = torch.Generator(device=device).manual_seed(seed)
    dep = family.deploy(s["config"], gen)
    pool = family.pool(dep, s["traffic"], gen)
    kept = [(i, family.control_output(lit, dep)) for i, lit in enumerate(pool)]
    worst, failed = family.check(dep, pool, kept, s["limits"])
    return dict(worst, failed=failed)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--base", type=int, default=3_000_000_000)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from perfbench import harness
    s = harness.spec(args.workload)
    family = importlib.import_module(
        f"perfbench.families.{s['config']['family']}")
    lower, upper = {}, {}
    for k in range(args.seeds):
        seed = args.base + k
        t0 = time.perf_counter()
        r = program_readings(s, seed, args.device)
        print(json.dumps(dict(side="program", seed=seed, **r,
                              seconds=time.perf_counter() - t0)), flush=True)
        for n in family.CHECKS:
            lower[n] = max(lower.get(n, 0.0), r[n])
    for k in range(args.control_seeds):
        seed = args.base + 1000 + k
        t0 = time.perf_counter()
        r = control_readings(s, seed, args.device)
        print(json.dumps(dict(side="control", seed=seed, **r,
                              seconds=time.perf_counter() - t0)), flush=True)
        for n in family.CHECKS:
            upper[n] = min(upper.get(n, float("inf")), r[n])
    print(json.dumps(dict(workload=args.workload, lower=lower, upper=upper)))
    return 0


if __name__ == "__main__":
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [root, os.path.join(root, "src")]
    sys.exit(main())
