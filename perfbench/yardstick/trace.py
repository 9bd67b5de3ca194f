"""A profiled window of the cell's traffic, reduced to what the device
did: its busy time, the kernels' time, the longest device operations and
the idle gaps by the host span they fell in.

The window runs under ``profile_window.device_profile`` (host and card),
each batch's host spans marked with ``record_function``.  The traced
window is the interval from the first span's start to the last span's
end, on the profiler's own clock; margins outside it are not counted.
"""
from __future__ import annotations

import collections
import dataclasses
import re
import time

from perfbench.yardstick.profile_window import device_profile

#: Device operations that are not kernels: the copies and fills.
_NOT_KERNEL = re.compile(r"^(Memcpy|Memset)")


@dataclasses.dataclass(frozen=True)
class Trace:
    busy_s: float      # seconds in which an operation ran on the card
    window_s: float    # length of the traced window
    kernel_s: float    # summed time of every kernel in the window
    batches: int       # batches issued in the window


def short(name: str) -> str:
    """A kernel's name without its namespace, template arguments and
    parameters (``impact_tiles``); copies and fills as the profiler
    names them."""
    if _NOT_KERNEL.match(name):
        return name
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    return re.split(r"[<(]", name, maxsplit=1)[0].rsplit("::", 1)[-1] or name


def reduce(events, span_names) -> tuple[Trace, dict]:
    """Kineto events of a profiled window -> (``Trace``, breakdown).  The
    spans' own marks on the card's timeline (the profiler's user
    annotations, named as the spans) are not device operations."""
    import torch
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    spans, dev = [], []
    for e in events:
        t0, t1 = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.name() in span_names:
            if e.device_type() == cpu:
                spans.append((t0, t1, e.name()))
        elif e.device_type() == cuda:
            dev.append((t0, t1, e.name()))
    spans.sort()
    w0, w1 = spans[0][0], max(s[1] for s in spans)
    dev = sorted((max(a, w0), min(b, w1), n) for a, b, n in dev
                 if b > w0 and a < w1)
    by_op = collections.Counter()
    kernel_ns = 0
    busy, cur = [], None
    for a, b, name in dev:
        by_op[short(name)] += b - a
        if not _NOT_KERNEL.match(name):
            kernel_ns += b - a
        if cur is not None and a <= cur[1]:
            cur[1] = max(cur[1], b)
        else:
            if cur is not None:
                busy.append(cur)
            cur = [a, b]
    if cur is not None:
        busy.append(cur)
    busy_ns = sum(b - a for a, b in busy)
    # Idle gaps, each split over the host spans it overlaps; the rest of a
    # gap fell between spans (the loop's own work).
    idle = collections.Counter()
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    k = 0
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        while k < len(spans) and spans[k][1] <= a:
            k += 1
        covered = 0
        j = k
        while j < len(spans) and spans[j][0] < b:
            o = min(b, spans[j][1]) - max(a, spans[j][0])
            if o > 0:
                idle[spans[j][2]] += o
                covered += o
            j += 1
        idle["between spans"] += (b - a) - covered
    top = lambda c: [[n, v / 1e9] for n, v in c.most_common(10) if v > 0]
    trace = Trace(busy_s=busy_ns / 1e9, window_s=(w1 - w0) / 1e9,
                  kernel_s=kernel_ns / 1e9,
                  batches=sum(1 for s in spans if s[2] == span_names[0]))
    return trace, dict(device_ops=top(by_op), idle_gaps=top(idle))


def profiled_window(cell, seconds: float, span_names):
    """Serve the cell's pool for ``seconds`` under the profiler -> (the
    window's ``Trace``, breakdown, its last ``(pool index, output)``)."""
    from torch.profiler import record_function
    P = len(cell.pool)
    with device_profile(cpu=True) as prof:
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            out, _ = cell.batch(n % P, {}, record_function)
            n += 1
    trace, breakdown = reduce(prof.profiler.kineto_results.events(),
                              tuple(span_names))
    return trace, breakdown, ((n - 1) % P, out)
