"""Run one cell of the benchmark once and print its result line.

``main`` is the command: it finds the cell, its configuration, traffic
mix, limits and metric readers by name (``spec``), refuses to run
without the card the cell asks for, and prints one JSON object as the
last line of standard output.  ``run`` does the rest and is what the CPU
tests drive.

A run: set-up (the family's deployment, traffic pool and compiled
program, then one warm-up batch a pool entry), a closed-loop window of
``seconds`` that keeps a sample of its batches' outputs drawn from the
seed, with ``--trace 1`` a profiled window after it, then the program's
state freed and every kept output held to the plain reference.  The
end-to-end metrics come from the window; with ``--trace 1`` the
per-layer metrics come from the same window (host spans, launches) and
the profiled one (device time).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import importlib.util
import json
import random
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: Top-level modules the process must not hold once the window closes.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: Outputs kept from a window for the check, drawn from the seed.
KEEP = 24
#: Length of the profiled window of a ``--trace 1`` run, in seconds.
TRACE_SECONDS = 2.0


@dataclasses.dataclass
class Run:
    """What one run measured, as the metric readers see it."""
    setup_s: float
    window_s: float
    batches: int
    datapoints: int
    batch_s: list
    spans: dict
    launches: int
    flops_per_datapoint: float
    sweep_bound_s: float
    trace: object = None       # yardstick.trace.Trace of a --trace 1 run


def spec(workload: str) -> dict:
    """The cell named ``workload`` and everything it names, read from
    ``BENCHMARK.json`` and the files under ``perfbench/``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    here = ROOT.joinpath
    named = lambda ms: [m for m in ms
                        if workload in m.get("workloads", [workload])]
    return dict(
        cell=cell,
        config=json.loads(here(config["file"]).read_text()),
        traffic=json.loads(here("perfbench", "traffic",
                                f"{cell['traffic']}.json").read_text()),
        limits=json.loads(here("perfbench", "limits",
                               f"{workload}.json").read_text())["limits"],
        end_to_end=named(bench["end_to_end"]),
        per_layer=named(bench["per_layer"]))


def reader(name: str):
    """The ``read(run)`` function of metric ``name``
    (``perfbench/metrics/<name>.py``)."""
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


class Reservoir:
    """A uniform sample of ``k`` of the window's outputs, drawn from the
    seed whatever the window's length."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items, self.seen = k, random.Random(seed), [], 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run(s: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    """One run of the cell ``s`` (``spec``'s dict) on ``device`` ->
    the result object.  ``t_start`` is the process's start on the host
    clock."""
    import torch
    family = importlib.import_module(f"perfbench.families."
                                     f"{s['config']['family']}")
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cell = family.Cell(s["config"], s["traffic"], seed, torch.device(device))
    P = len(cell.pool)
    for i in range(P):
        cell.batch(i, {})
    sync()
    gc.collect()
    keep = Reservoir(KEEP, seed)
    spans, batch_s = {}, []
    launches0 = cell.launches()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    n = 0
    while True:
        out, dt = cell.batch(n % P, spans)
        batch_s.append(dt)
        keep.offer((n % P, out))
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    r = Run(setup_s=setup_s, window_s=window_s, batches=n,
            datapoints=n * cell.batch_size, batch_s=batch_s, spans=spans,
            launches=cell.launches() - launches0,
            flops_per_datapoint=cell.flops_per_datapoint,
            sweep_bound_s=cell.sweep_bound_s)
    breakdown = None
    if trace:
        from perfbench.yardstick import trace as trace_mod
        r.trace, breakdown, last = trace_mod.profiled_window(
            cell, TRACE_SECONDS, family.SPANS)
        keep.items.append(last)
    device_info = dict(platform="gpu" if cuda else "cpu",
                       kind=(torch.cuda.get_device_name(0) if cuda
                             else "cpu"),
                       count=1,
                       memory_peak_bytes=(torch.cuda.max_memory_allocated()
                                          if cuda else 0))
    if r.trace is not None:
        device_info.update(busy_s=r.trace.busy_s, window_s=r.trace.window_s)
    dep, pool_ = cell.dep, cell.pool
    cell.close()
    del cell
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    worst, failed = family.check(dep, pool_, keep.items, s["limits"])
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the process holds {', '.join(found)} after the "
                         f"window: the benchmark must not load JAX or the "
                         f"JAX package")
    checks = {name: dict(value=worst[name], limit=limit)
              for name, limit in s["limits"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    for m in (s["per_layer"] if trace else s["end_to_end"]):
        v = reader(m["name"])(r)
        if v is not None:
            metrics[m["name"]] = dict(value=v, unit=m["unit"])
    result = dict(correct=correct, attempted=r.datapoints, failed=failed,
                  metrics=metrics, device=device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("no src/repro_torch beside perfbench/: the benchmark needs "
              "the program it measures", file=sys.stderr)
        return 2
    s = spec(args.workload)
    import torch
    chips = s["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 3
    result = run(s, args.seed, args.seconds, bool(args.trace), "cuda",
                 t_start)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
