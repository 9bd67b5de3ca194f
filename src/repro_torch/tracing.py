"""Tracing for the port: the serving engines' Chrome-tracing emitter
(``Tracer``, a copy of ``repro.serve.tracing``) and a process-level table
of spans and counters inside the session, graph and billing code.

The span table
--------------

``span(name)`` times a region of the program, ``add(name, n)`` counts
something (bytes, captures).  They record only while a
``torch.profiler`` window is recording
(``torch.autograd.profiler._is_profiler_enabled``) or after ``enable()``.
Off, a span site costs a global read, an attribute read and a shared
null context: it reads no clock, allocates nothing and opens no
``record_function`` range.  On, a span reads ``time.perf_counter_ns``
twice and adds to the table under a lock.

* ``totals()``: for each name, ``count`` (calls of a span; the sum of
  what ``add`` added for a counter), ``seconds``, ``self_seconds`` (the
  seconds less those of the spans recorded inside it) and ``parent``,
  the enclosing span of the name's first record.
* ``spans()``: the last ``MAX_SPANS`` records ``(name, parent,
  start_ns, end_ns)``.  Their times are on the profiler's clock: the
  epoch nanoseconds of kineto's host events, as ``perf_counter_ns`` plus
  an offset ``time.time_ns() - perf_counter_ns()`` taken when the table
  starts and again at most once a second while it records (the
  approximation kineto's own converter makes).  So each span can be laid
  on a device trace of the same window.
* ``nest(records)``: the records' begin and end marks, nested.
* ``to_tracer(records)``: the records as a ``Tracer`` (Chrome JSON).
* ``add_device(name, t)``: a counter whose value is a scalar on the
  card, summed there while the table records; ``flush()`` reads every
  such sum with one copy to the host and adds it to the table (the
  caller flushes where its results come to the host anyway).
* ``reset()``, ``enable()``, ``disable()``.

No span opens a ``record_function`` range: a range with launches inside
it draws a user annotation on the card's timeline, which a reader of the
device trace would count as device work.  Spans nest per thread; the
table is one for the process.

The Chrome-tracing emitter
--------------------------

The CI perf gates see *aggregates* (samples/s, p95); diagnosing a tail
regression needs the *timeline* those aggregates summarize.  ``Tracer``
is a zero-dependency (stdlib ``json`` only) emitter of the Chrome Trace
Event Format — the JSON *array* flavour that ``chrome://tracing`` and
Perfetto load directly — so one serving run can be opened as a flame
graph: a ``scheduler`` track with per-step ``admission`` / ``sweep`` /
``release`` / ``billing`` spans, and one track per request with its
``queued`` -> ``admitted`` -> ``sweep`` -> ``billed`` lifecycle, cut
from the same ``RequestRecord`` / ``BatchStats`` timestamps the latency
ledger reports (so span durations reconcile with the ledger by
construction).

Design notes:

* **Timestamps are engine-clock seconds.**  Every span carries the raw
  reading of the engine's injectable ``clock`` — a virtual test clock
  traces exactly like a wall clock.  ``to_json`` rebases on the first
  event and converts to the microseconds the trace viewers expect.
* **B/E duration events.**  Spans are emitted as balanced
  begin/end pairs per track (``ph: "B"``/``"E"``), which Perfetto nests
  by timestamp; ``instant`` marks zero-width occurrences (e.g. a shed
  request) and ``counter`` emits occupancy-style counter tracks.
* **Per-request spans are emitted at completion** from the record's
  timestamps, never half-open across scheduler steps — a written trace
  always balances, even if the engine still holds queued work.
* **Threading model.**  ``pid`` 0 is the engine (scheduler tid 0);
  ``pid`` 1 holds one tid per request (tid == rid).  Metadata events
  name both so the viewer shows "scheduler" / "req N" tracks.  Multi-
  tenant producers (``serve.zoo``) claim one pid per tenant from
  ``PID_TENANT_BASE`` up via ``name_process`` — one Perfetto track
  group per tenant, request tids nested under it.

The emitter is engine-agnostic on purpose: ``serve.impact_engine``
threads it through the crossbar scheduler, and every later timeline
producer (multi-tenant zoo, online training) appends to the same span
vocabulary.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import threading
import time
from typing import Any, Callable, Iterator

import torch.autograd.profiler as _profiler

PID_ENGINE = 0
PID_REQUESTS = 1
#: First pid available to per-tenant request tracks (``serve.zoo``): the
#: zoo names pid ``PID_TENANT_BASE + model_id`` after each tenant.
PID_TENANT_BASE = 2

#: Span names of the per-request lifecycle, in timeline order.
REQUEST_PHASES = ("queued", "admitted", "sweep", "billed")


@dataclasses.dataclass
class Tracer:
    """Collects trace events in memory; ``write`` renders one loadable
    ``.trace.json``.  All ``ts`` arguments are seconds on the owning
    engine's clock (``clock`` is only the default source when a caller
    omits ``ts``)."""

    clock: Callable[[], float] = time.time
    cat: str = "serve"

    def __post_init__(self):
        self.events: list[dict[str, Any]] = []
        self._named: set[tuple[int, int | None]] = set()
        self._pid_names: dict[int, str] = {}

    def __len__(self) -> int:
        return len(self.events)

    # -- naming ------------------------------------------------------------
    def name_process(self, pid: int, name: str) -> None:
        """Claim a custom name for a process track (e.g. one per tenant:
        ``name_process(PID_TENANT_BASE + t, f"tenant {tid}")``).  Must be
        called before the first event on that pid; later calls on an
        already-emitted pid are ignored (metadata is emitted once)."""
        self._pid_names[pid] = name

    def _ensure_named(self, pid: int, tid: int) -> None:
        """Emit process/thread metadata once per track so the viewer
        labels the engine and request rows."""
        if (pid, None) not in self._named:
            self._named.add((pid, None))
            name = self._pid_names.get(
                pid, "engine" if pid == PID_ENGINE else "requests")
            self.events.append(dict(name="process_name", ph="M", pid=pid,
                                    tid=0, args=dict(name=name)))
        if (pid, tid) not in self._named:
            self._named.add((pid, tid))
            name = ("scheduler" if pid == PID_ENGINE and tid == 0
                    else f"req {tid}" if pid >= PID_REQUESTS
                    else f"tid {tid}")
            self.events.append(dict(name="thread_name", ph="M", pid=pid,
                                    tid=tid, args=dict(name=name)))

    # -- span primitives ----------------------------------------------------
    def begin(self, name: str, *, ts: float | None = None, tid: int = 0,
              pid: int = PID_ENGINE, args: dict | None = None) -> None:
        self._ensure_named(pid, tid)
        ev = dict(name=name, ph="B", ts=self.clock() if ts is None else ts,
                  pid=pid, tid=tid, cat=self.cat)
        if args:
            ev["args"] = args
        self.events.append(ev)

    def end(self, name: str, *, ts: float | None = None, tid: int = 0,
            pid: int = PID_ENGINE, args: dict | None = None) -> None:
        ev = dict(name=name, ph="E", ts=self.clock() if ts is None else ts,
                  pid=pid, tid=tid, cat=self.cat)
        if args:
            ev["args"] = args
        self.events.append(ev)

    def span(self, name: str, t_begin: float, t_end: float, *, tid: int = 0,
             pid: int = PID_ENGINE, args: dict | None = None) -> None:
        """One closed [t_begin, t_end] span as a balanced B/E pair."""
        self.begin(name, ts=t_begin, tid=tid, pid=pid, args=args)
        self.end(name, ts=t_end, tid=tid, pid=pid)

    def instant(self, name: str, *, ts: float | None = None, tid: int = 0,
                pid: int = PID_ENGINE, args: dict | None = None) -> None:
        self._ensure_named(pid, tid)
        ev = dict(name=name, ph="i", s="t",
                  ts=self.clock() if ts is None else ts,
                  pid=pid, tid=tid, cat=self.cat)
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, name: str, value: float, *,
                ts: float | None = None, pid: int = PID_ENGINE) -> None:
        """Counter track (e.g. slot-table occupancy over time)."""
        self._ensure_named(pid, 0)
        self.events.append(dict(
            name=name, ph="C", ts=self.clock() if ts is None else ts,
            pid=pid, tid=0, cat=self.cat, args={name: float(value)}))

    @contextlib.contextmanager
    def region(self, name: str, *, tid: int = 0, pid: int = PID_ENGINE,
               args: dict | None = None) -> Iterator[None]:
        """Live span around a code region, timed on the tracer's clock."""
        self.begin(name, tid=tid, pid=pid, args=args)
        try:
            yield
        finally:
            self.end(name, tid=tid, pid=pid)

    # -- request lifecycle ---------------------------------------------------
    def request_spans(self, *, rid: int, arrived: float, admitted: float,
                      sweep_start: float, sweep_end: float, billed: float,
                      lane: int, shape: int, args: dict | None = None,
                      pid: int = PID_REQUESTS) -> None:
        """The per-request lifecycle as four contiguous spans on the
        request's own track.  ``queued`` + ``admitted`` + ``sweep`` is
        exactly ``RequestRecord.latency_s`` (same clock readings); the
        ``billed`` epilogue prices the host-side accounting after the
        sweep returned.  ``pid`` selects the track group — the default
        single-tenant "requests" process, or a per-tenant pid named via
        ``name_process`` (the multi-tenant zoo)."""
        extra = dict(lane=lane, shape=shape)
        if args:
            extra.update(args)
        self.span("queued", arrived, admitted, tid=rid, pid=pid,
                  args=dict(rid=rid))
        self.span("admitted", admitted, sweep_start, tid=rid,
                  pid=pid, args=dict(lane=lane))
        self.span("sweep", sweep_start, sweep_end, tid=rid,
                  pid=pid, args=extra)
        self.span("billed", sweep_end, billed, tid=rid, pid=pid)

    # -- rendering -----------------------------------------------------------
    def to_json(self) -> list[dict[str, Any]]:
        """Render the event array: timestamps rebased on the earliest
        event and scaled to microseconds, events sorted by time (stable,
        so a B emitted before an E at the same instant stays nested)."""
        timed = [e for e in self.events if "ts" in e]
        meta = [dict(e, ts=0.0) for e in self.events if "ts" not in e]
        base = min((e["ts"] for e in timed), default=0.0)
        out = meta + [dict(e, ts=(e["ts"] - base) * 1e6)
                      for e in timed]
        out.sort(key=lambda e: e["ts"])
        return out

    def write(self, path) -> None:
        """Write one Chrome-tracing JSON array, loadable by
        ``chrome://tracing`` and https://ui.perfetto.dev."""
        with open(path, "w") as f:
            json.dump(self.to_json(), f)


def validate_events(events: list[dict]) -> None:
    """Structural validity of a rendered event array — what a trace
    viewer needs to load it: every event carries name/ph/ts/pid/tid,
    timestamps are globally monotonic (the writer sorts), and B/E pairs
    balance (and properly nest) per (pid, tid) track.  Raises
    ``ValueError`` on the first violation; used by the tests and by
    ``Tracer.write`` consumers that want a loadability check without a
    browser."""
    last_ts = float("-inf")
    stacks: dict[tuple[int, int], list[str]] = {}
    for e in events:
        for field in ("name", "ph", "pid", "tid"):
            if field not in e:
                raise ValueError(f"event missing {field!r}: {e}")
        if e["ph"] == "M":
            continue
        if "ts" not in e:
            raise ValueError(f"timed event missing ts: {e}")
        if e["ts"] < last_ts:
            raise ValueError(
                f"non-monotonic ts: {e['ts']} after {last_ts} ({e})")
        last_ts = e["ts"]
        key = (e["pid"], e["tid"])
        if e["ph"] == "B":
            stacks.setdefault(key, []).append(e["name"])
        elif e["ph"] == "E":
            stack = stacks.get(key)
            if not stack:
                raise ValueError(f"E without matching B on track {key}: {e}")
            top = stack.pop()
            if top != e["name"]:
                raise ValueError(
                    f"interleaved spans on track {key}: E {e['name']!r} "
                    f"closes B {top!r}")
    open_spans = {k: v for k, v in stacks.items() if v}
    if open_spans:
        raise ValueError(f"unbalanced B/E pairs per tid: {open_spans}")


# -- the span table ------------------------------------------------------

#: Records ``spans()`` keeps, the newest.
MAX_SPANS = 1 << 17
#: Longest run of recording on one clock offset before it is taken again.
OFFSET_REFRESH_NS = 1_000_000_000
#: The pid ``to_tracer`` puts the program's spans on, above any tenant's.
PID_PROGRAM = 1 << 20

_clock = time.perf_counter_ns
_wall = time.time_ns
_on = False
_lock = threading.Lock()
_local = threading.local()
# name -> [count, ns, self ns, parent]
_totals: dict[str, list] = {}
_records: collections.deque = collections.deque(maxlen=MAX_SPANS)
# name -> a scalar tensor summed on its device since the last flush()
_device: dict[str, Any] = {}
_offset = [0, 0]    # [epoch ns - perf ns, perf ns when taken]


class _Null:
    """The shared context of a span site that records nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _take_offset() -> None:
    t = _clock()
    _offset[:] = [_wall() - t, t]


class _Span:
    __slots__ = ("name", "stack", "parent", "child_ns", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        self.stack = stack
        self.parent = stack[-1] if stack else None
        self.child_ns = 0
        stack.append(self)
        self.t0 = _clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = _clock()
        self.stack.pop()
        t0, parent = self.t0, self.parent
        ns = t1 - t0
        if parent is None:
            name = None
        else:
            parent.child_ns += ns
            name = parent.name
        own = ns - self.child_ns
        with _lock:
            if t1 - _offset[1] > OFFSET_REFRESH_NS:
                _take_offset()
            off = _offset[0]
            _records.append((self.name, name, t0 + off, t1 + off))
            row = _totals.get(self.name)
            if row is None:
                _totals[self.name] = [1, ns, own, name]
            else:
                row[0] += 1
                row[1] += ns
                row[2] += own
        return False


def recording() -> bool:
    """Whether span sites record now: a profiler window is recording, or
    ``enable()`` was called."""
    return _on or _profiler._is_profiler_enabled


def span(name: str):
    """A context that times its body as span ``name`` while ``recording()``,
    and the shared null context otherwise."""
    if _on or _profiler._is_profiler_enabled:
        return _Span(name)
    return _NULL


def add(name: str, n: int = 1, *, always: bool = False) -> None:
    """Add ``n`` to counter ``name`` while ``recording()``, or always with
    ``always`` (for what happens only at set-up)."""
    if always or _on or _profiler._is_profiler_enabled:
        stack = getattr(_local, "stack", None)
        parent = stack[-1].name if stack else None
        with _lock:
            row = _totals.get(name)
            if row is None:
                _totals[name] = [n, 0, 0, parent]
            else:
                row[0] += n


def add_device(name: str, t) -> None:
    """Add the scalar tensor ``t`` to counter ``name`` on its device while
    ``recording()``: nothing is read until ``flush()``."""
    if _on or _profiler._is_profiler_enabled:
        t = t.detach().double()
        with _lock:
            prev = _device.get(name)
            _device[name] = t if prev is None else prev + t


def flush() -> None:
    """Read the counters ``add_device`` summed on the device (one copy to
    the host) and add them to the table."""
    with _lock:
        names, vals = list(_device), list(_device.values())
        _device.clear()
    if not names:
        return
    import torch
    for name, v in zip(names, torch.stack(vals).tolist()):
        add(name, v, always=True)


def totals() -> dict[str, dict]:
    """``{name: {"count", "seconds", "self_seconds", "parent"}}`` of every
    span and counter recorded since the last ``reset()``."""
    with _lock:
        return {name: dict(count=c, seconds=ns / 1e9,
                           self_seconds=self_ns / 1e9, parent=parent)
                for name, (c, ns, self_ns, parent) in _totals.items()}


def spans() -> list[tuple[str, str | None, int, int]]:
    """The kept span records ``(name, parent, start_ns, end_ns)`` in the
    order they ended, times in epoch nanoseconds (the profiler's clock)."""
    with _lock:
        return list(_records)


def reset() -> None:
    """Empty the table and take the clock offset again."""
    with _lock:
        _totals.clear()
        _records.clear()
        _device.clear()
        _take_offset()


def enable() -> None:
    """Record with no profiler running, until ``disable()``."""
    global _on
    _on = True


def disable() -> None:
    """Record only while a profiler window is recording."""
    global _on
    _on = False


def nest(records) -> list[tuple[int, bool, str]]:
    """Span records ``(name, parent, start_ns, end_ns)`` -> their begin and
    end marks ``(ns, begins, name)`` in time order, each span nested in
    the one open when it began: records by start, the longer first, and
    an end past the enclosing span's cut to it."""
    marks, open_ = [], []
    for name, _, t0, t1 in sorted(records, key=lambda r: (r[2], -r[3])):
        while open_ and open_[-1][1] <= t0:
            done, end = open_.pop()
            marks.append((end, False, done))
        marks.append((t0, True, name))
        # A record of another thread may outlast the one it started in.
        open_.append((name, min(t1, open_[-1][1]) if open_ else t1))
    while open_:
        done, end = open_.pop()
        marks.append((end, False, done))
    return marks


def to_tracer(records=None) -> Tracer:
    """Span records (``spans()`` by default) as a ``Tracer``: B/E pairs on
    one track of pid ``PID_PROGRAM``, nested as they ran (``nest``), in
    seconds since the first record's start; ``.write(path)`` writes the
    Chrome JSON."""
    records = spans() if records is None else list(records)
    tracer = Tracer()
    tracer.name_process(PID_PROGRAM, "program")
    tracer._ensure_named(PID_PROGRAM, 0)
    tracer.events[-1]["args"]["name"] = "host"      # its thread_name
    if not records:
        return tracer
    base = min(r[2] for r in records)
    for ns, begins, name in nest(records):
        (tracer.begin if begins else tracer.end)(
            name, ts=(ns - base) / 1e9, pid=PID_PROGRAM)
    return tracer

_take_offset()
