"""Profile windows that keep every device event.

``torch.profiler`` reports only the device events that fall inside its
window, and a window that launches its first kernel as it opens can lose
the events of its first kernels, or of all of them.  ``device_profile``
keeps ``MARGIN_S`` of idle time at each end of its window, so a gate
that counts the kernels of a window counts them all.  ``idle_by_span``
lays the card's idle gaps of such a window on the program's spans
(``repro_torch.tracing``), which record while the profiler does.

    python -m repro_torch.analysis.profile_window [--windows N]

needs a card: it opens ``N`` windows of ``CALLS`` launches of
``clause_eval`` at the training path's digital shape each, with and
without the margin, with and without the host's activity, and prints
how many windows lost device events and which launches they lost.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import time

import numpy as np
import torch

from .. import tracing

MARGIN_S = 0.05
# clause_eval at the training path's digital shape (B, K, N), CALLS
# launches a window, as chip_smoke.py's profile gates have.
SHAPE, CALLS = (256, 1568, 500), 50
#: Where ``idle_by_span`` puts idle time no program span covers.
OUTSIDE = "outside the program"


@contextlib.contextmanager
def device_profile(cpu: bool = False, margin_s: float = MARGIN_S):
    """``torch.profiler.profile`` of the card's activity (and the host's
    with ``cpu``) whose window keeps ``margin_s`` of idle time before the
    body and after the body's work has finished."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        time.sleep(margin_s)
        yield prof
        torch.cuda.synchronize()
        time.sleep(margin_s)


def idle_by_span(events, spans) -> dict[str, float]:
    """Seconds the card sat idle, by the innermost program span the host
    was in -> ``{span name or OUTSIDE: seconds}``, largest first.

    ``events``: the kineto events of a profiled window
    (``prof.profiler.kineto_results.events()``); the card is busy while
    one of its kernels, copies or fills runs (its user annotations are
    not work).  ``spans``: ``repro_torch.tracing.spans()`` records of the
    same window, on the same clock.  The window runs from the first
    span's start to the last one's end; idle time there that no span
    covers goes to ``OUTSIDE``: the caller's own code between the
    program's calls."""
    marks = tracing.nest(spans)
    if not marks:
        return {}
    w0, w1 = marks[0][0], marks[-1][0]
    cuda = torch.autograd.DeviceType.CUDA
    busy = sorted(
        (max(a, w0), min(b, w1)) for a, b in (
            (e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
            if e.device_type() == cuda and not e.is_user_annotation())
        if b > w0 and a < w1)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    # Contiguous segments of the window, each under its innermost span.
    segs, names, t = [], [], w0
    for ns, begins, name in marks:
        if ns > t:
            segs.append((t, ns, names[-1] if names else OUTSIDE))
            t = ns
        if begins:
            names.append(name)
        else:
            names.pop()
    idle = collections.Counter()
    k = 0
    for a, b in gaps:
        while k < len(segs) and segs[k][1] <= a:
            k += 1
        j = k
        while j < len(segs) and segs[j][0] < b:
            overlap = min(b, segs[j][1]) - max(a, segs[j][0])
            if overlap > 0:
                idle[segs[j][2]] += overlap
            j += 1
    return {name: ns / 1e9 for name, ns in idle.most_common()}


def window(fn, calls: int, cpu: bool, margin_s: float) -> dict:
    """One window of ``calls`` calls of ``fn`` (one kernel a call): the
    device events it kept and, with ``cpu``, the indices of the launches
    whose kernels it lost."""
    fn()
    torch.cuda.synchronize()
    with device_profile(cpu, margin_s) as prof:
        for _ in range(calls):
            fn()
    events = prof.profiler.kineto_results.events()
    kept = [e for e in events
            if e.device_type() == torch.autograd.DeviceType.CUDA]
    seen = {e.correlation_id() for e in kept}
    launches = sorted((e for e in events if "LaunchKernel" in e.name()),
                      key=lambda e: e.start_ns())
    return dict(kept=len(kept),
                lost=[i for i, e in enumerate(launches)
                      if e.correlation_id() not in seen])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--windows", type=int, default=1000)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_window needs a CUDA card")
    from ..kernels import build_all
    from ..kernels.clause_eval import clause_eval
    print(f"build {build_all():.1f} s; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    rng = np.random.default_rng(0)
    B, K, N = SHAPE
    lit = torch.from_numpy(rng.integers(0, 2, (B, K), dtype=np.int8)).cuda()
    inc = torch.from_numpy(rng.random((K, N)) < 0.01).cuda()
    ne = inc.any(0)
    results = {}
    for margin_s in (0.0, MARGIN_S):
        for cpu in (False, True):
            t0 = time.perf_counter()
            res = [window(lambda: clause_eval(lit, inc, ne), CALLS, cpu,
                          margin_s) for _ in range(args.windows)]
            bad = [r for r in res if r["kept"] != CALLS]
            tag = f"margin {margin_s * 1e3:.0f} ms, " + (
                "card and host" if cpu else "card")
            print(f"{tag}: {len(bad)} of {args.windows} windows of "
                  f"{CALLS} launches lost device events "
                  f"({time.perf_counter() - t0:.1f} s)")
            for r in bad[:10]:
                print(f"  kept {r['kept']}"
                      + (f"; lost launches {r['lost'][:4]}..{r['lost'][-1]}"
                         if r["lost"] else ""))
            results[tag] = dict(windows=args.windows, lost=len(bad),
                                kept=[r["kept"] for r in bad])
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
