"""``python -m repro_torch.paper [--only table4,table5,table6,fig7_8,fig13]
[--device cpu]``: the paper's sections in the reference's order
(``benchmarks/run.py``), one ``name,us_per_call,derived`` CSV.

Before the header it prints ``# card: <name>, <power limit>`` (from
``nvidia-smi``) or ``# device: cpu``.  A section that raises prints the
reference's ``<name>/ERROR,0.0,...`` row, its traceback goes to stderr,
the remaining sections still run, and the run exits 1.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import traceback

from ..device import resolve_device
from . import (fig7_8_variability, fig13_tuning_sweep, table4_energy,
               table5_datasets, table6_comparison)

SECTIONS = {
    "table4": table4_energy.main,
    "table5": table5_datasets.main,
    "table6": table6_comparison.main,
    "fig7_8": fig7_8_variability.main,
    "fig13": fig13_tuning_sweep.main,
}


def card_line(device) -> str:
    if device.type != "cuda":
        return f"# device: {device.type}"
    idx = 0 if device.index is None else device.index
    out = subprocess.run(
        ["nvidia-smi", "-i", str(idx), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return f"# card: {out}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated section names to run")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)
    chosen = args.only.split(",") if args.only else list(SECTIONS)
    unknown = sorted(set(chosen) - set(SECTIONS))
    if unknown:
        ap.error(f"unknown sections {unknown}; choose from {list(SECTIONS)}")
    dev = resolve_device(args.device)
    print(card_line(dev))
    print("name,us_per_call,derived", flush=True)
    failed = 0
    for name in chosen:
        try:
            SECTIONS[name](device=dev)
        except Exception as e:
            failed += 1
            print(f"{name}/ERROR,0.0,{type(e).__name__}:{str(e)[:120]}",
                  flush=True)
            traceback.print_exc(file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
