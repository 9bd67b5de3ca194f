"""Chrome-tracing span emitter for the serving engines (a copy of
``repro.serve.tracing``: stdlib only).

The CI perf gates see *aggregates* (samples/s, p95); diagnosing a tail
regression needs the *timeline* those aggregates summarize.  This module
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

import contextlib
import dataclasses
import json
import time
from typing import Any, Callable, Iterator

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
