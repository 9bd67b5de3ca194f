"""The port's tracing module: the span table inside the session, graph and
billing code (``repro_torch.tracing``), its gate, its clock and its
export.

On the CPU a session's graphs go through the recorder of
``tests/_torch_graph_recorder.py``, so ``GraphedEntry``'s copy in,
replay and clone out run as on a card.  The card's test
(``-m card``) runs a captured graph under
``analysis.profile_window.device_profile`` and holds the spans to the
profiler's own clock.  Imports no JAX.
"""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import tracing
from repro_torch.convert import system_from_arrays
from repro_torch.impact import RuntimeSpec
from repro_torch.impact.yflash import read_current

from _torch_graph_recorder import Recorder, patch

# (B, K, n, M, tr, tc, sr): one clause tile, one class tile.
B, K, N, M, TR, TC, SR = 8, 32, 12, 3, 32, 16, 16
SERVING = ("runtime.infer_step", "graphs.copy_in", "graphs.replay",
           "graphs.clone")


def _system(device="cpu"):
    rng = np.random.default_rng(0)
    include = rng.random((TR, TC)) < 0.1
    include[:, N:] = False
    include[0, :N] = True
    clause_g = np.where(include, 2.5e-6, 0.9e-9).astype(np.float32)[None,
                                                                    None]
    class_g = rng.uniform(1e-9, 2.5e-6, (1, SR, M)).astype(np.float32)
    class_g[:, N:] = 0
    d = dict(clause_g=clause_g, class_g=class_g,
             clause_i=read_current(torch.from_numpy(clause_g)).numpy(),
             class_i=read_current(torch.from_numpy(class_g)).numpy(),
             nonempty=include.any(axis=0), n_literals=K, n_clauses=N,
             n_classes=M, program_energy_j=0.0, erase_energy_j=0.0)
    lits = rng.random((B, K)) < 0.5
    valid = np.ones(B, bool)
    valid[1] = False
    return system_from_arrays(d, device=device), lits, valid


def _boom(*args, **kw):
    raise AssertionError("called on the off path")


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none (decided when the test
    runs, never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def table():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture
def graphed(monkeypatch):
    return patch(monkeypatch.setattr, Recorder())


def _session(system, **kw):
    return system.compile(RuntimeSpec(device="cpu", metering="fused",
                                      capacity=B, **kw))


def _bill(system, res):
    return system.step_report(res.e_clause_lanes.numpy(),
                              res.e_class_lanes.numpy(), B)


@pytest.mark.parametrize("graph", [False, True], ids=["eager", "graphed"])
def test_off_path_reads_no_clock_and_opens_no_range(monkeypatch, graph):
    if graph:
        patch(monkeypatch.setattr, Recorder())
    system, lits, valid = _system()
    sess = _session(system)
    assert sess.graphed == graph
    sess.predict(lits)              # prepared: no capture below
    sess.infer_with_report(lits, valid)
    tracing.reset()
    for mod, name in ((tracing, "_clock"), (tracing, "_wall"),
                      (torch.profiler, "record_function"),
                      (torch.autograd.profiler, "record_function")):
        monkeypatch.setattr(mod, name, _boom)
    assert not tracing.recording()
    for _ in range(2):
        res = sess.infer_step(lits, valid)
        _bill(system, res)
    sess.predict(lits)
    sess.infer_with_report(lits, valid)
    assert tracing.totals() == {} and tracing.spans() == []
    assert tracing.span("x") is tracing.span("y")


def test_profiler_turns_the_table_on(graphed):
    system, lits, valid = _system()
    sess = _session(system)
    with profile(activities=[ProfilerActivity.CPU]):
        on = tracing.recording()
        for _ in range(2):
            _bill(system, sess.infer_step(lits, valid))
    assert on and not tracing.recording()
    sess.infer_step(lits, valid)            # after the window: nothing
    t = tracing.totals()
    for name in SERVING:
        assert t[name]["count"] == 2, name
    assert t["pipeline.step_report"]["count"] == 2
    assert t["runtime.infer_step"]["parent"] is None
    assert t["pipeline.step_report"]["parent"] is None
    for name in SERVING[1:]:
        assert t[name]["parent"] == "runtime.infer_step"
        assert t[name]["self_seconds"] == t[name]["seconds"] > 0
    children = sum(t[name]["seconds"] for name in SERVING[1:])
    top = t["runtime.infer_step"]
    assert top["self_seconds"] == pytest.approx(top["seconds"] - children,
                                                abs=1e-12)
    assert 0 < top["self_seconds"] < top["seconds"]
    # The host's staging buffer is not used on the CPU: nothing waits.
    assert "graphs.staging_wait" not in t
    assert len(tracing.spans()) == 2 * 5


def test_each_entry_has_its_span(graphed):
    system, lits, valid = _system()
    sess = _session(system)
    tracing.enable()
    sess.predict(lits)
    sess.infer_with_report(lits, valid)
    t = tracing.totals()
    for name in ("runtime.predict", "runtime.infer_with_report"):
        assert t[name]["count"] == 1 and t[name]["parent"] is None
    # predict is prepared at B on first use: its capture is a child.
    assert t["graphs.capture"]["parent"] == "runtime.predict"
    assert t["graphs.replay"]["count"] == 2


def test_self_seconds_on_a_fake_clock(monkeypatch):
    ticks = iter([0, 10, 40, 50, 70, 100])
    monkeypatch.setattr(tracing, "_clock", lambda: next(ticks))
    tracing.enable()
    with tracing.span("outer"):
        with tracing.span("inner"):
            tracing.add("bytes", 5)
        with tracing.span("inner"):
            tracing.add("bytes", 7)
    t = tracing.totals()
    assert t["outer"] == dict(count=1, seconds=100e-9, self_seconds=50e-9,
                              parent=None)
    assert t["inner"] == dict(count=2, seconds=50e-9, self_seconds=50e-9,
                              parent="outer")
    assert t["bytes"] == dict(count=12, seconds=0.0, self_seconds=0.0,
                              parent="inner")
    (n1, p1, a1, b1), (n2, _, a2, b2), (n3, p3, a3, b3) = tracing.spans()
    assert (n1, p1, n3, p3) == ("inner", "outer", "outer", None)
    assert (b1 - a1, b2 - a2, b3 - a3) == (30, 20, 100)


def test_enable_disable_and_reset():
    with tracing.span("before"):
        pass
    tracing.add("off")
    tracing.add("setup", 2, always=True)
    assert set(tracing.totals()) == {"setup"}
    tracing.enable()
    assert tracing.recording()
    with tracing.span("on"):
        pass
    tracing.disable()
    assert not tracing.recording()
    with tracing.span("after"):
        pass
    assert set(tracing.totals()) == {"setup", "on"}
    assert [r[0] for r in tracing.spans()] == ["on"]
    tracing.reset()
    assert tracing.totals() == {} and tracing.spans() == []


def test_graph_bytes_and_captures(graphed):
    system, lits, valid = _system()
    sess = _session(system)
    # The capacity's capture at compile, counted with the table off.
    t = tracing.totals()
    assert t["graphs.captures"]["count"] == 1 and "graphs.capture" not in t
    tracing.reset()
    tracing.enable()
    calls = 3
    for _ in range(calls):
        res = sess.infer_step(lits, valid)
    specs = sess.input_specs("infer_step", B)
    in_bytes = sum(int(np.prod(shape)) * dtype.itemsize
                   for shape, dtype in specs)
    out_bytes = B * (torch.int64.itemsize + 2 * torch.float32.itemsize)
    assert in_bytes == B * K + B
    assert out_bytes == sum(x.numel() * x.element_size() for x in (
        res.predictions, res.e_clause_lanes, res.e_class_lanes))
    t = tracing.totals()
    assert t["graphs.copy_in_bytes"]["count"] == calls * in_bytes
    assert t["graphs.clone_bytes"]["count"] == calls * out_bytes
    assert t["graphs.copy_in_bytes"]["parent"] == "runtime.infer_step"
    # A new operand shape drops the graph; the next call captures again.
    system.class_i = torch.cat([system.class_i, torch.zeros(
        (*system.class_i.shape[:2], 1))], dim=2)
    sess.refresh_operands()
    sess.infer_step(lits, valid)
    t = tracing.totals()
    assert t["graphs.captures"]["count"] == 1
    assert t["graphs.capture"]["count"] == 1
    assert t["graphs.capture"]["parent"] == "runtime.infer_step"
    assert sum(1 for e in graphed.log if e[0] == "capture") == 2


def test_spans_lie_on_the_profilers_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # The first range of a window takes ~0.5 ms to open.
        with record_function("warm"):
            pass
        for _ in range(5):
            with record_function("host range"):
                with tracing.span("inner"):
                    torch.ones(4).add_(1)
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == "host range")
    recs = sorted(r[2:] for r in tracing.spans() if r[0] == "inner")
    assert len(ranges) == len(recs) == 5
    for (r0, r1), (s0, s1) in zip(ranges, recs):
        assert r0 - 50_000 <= s0 and s1 <= r1 + 50_000, (r0, r1, s0, s1)
    # A start within 50 us of its range's; the median, since the host
    # may be taken away between the two.
    gaps = sorted(abs(s0 - r0) for (r0, _), (s0, _) in zip(ranges, recs))
    assert gaps[2] < 50_000, gaps


def test_spans_are_bounded():
    tracing.enable()
    for _ in range(tracing.MAX_SPANS + 10):
        with tracing.span("a"):
            pass
    with tracing.span("b"):
        pass
    kept = tracing.spans()
    assert len(kept) == tracing.MAX_SPANS
    assert kept[-1][0] == "b"
    assert tracing.totals()["a"]["count"] == tracing.MAX_SPANS + 10


def test_export_is_loadable_chrome_json(tmp_path, graphed):
    system, lits, valid = _system()
    sess = _session(system)
    tracing.enable()
    for _ in range(3):
        _bill(system, sess.infer_step(lits, valid))
    records = tracing.spans()
    # Records that share their ends with their parent, or start where
    # another ends.
    extra = [("p", None, 10, 20), ("c", "p", 10, 20), ("d", "p", 15, 20),
             ("q", None, 20, 30)]
    for recs in (records, extra):
        tr = tracing.to_tracer(recs)
        events = tr.to_json()
        tracing.validate_events(events)
        assert sum(e["ph"] == "B" for e in events) == len(recs)
        path = tmp_path / "program.trace.json"
        tr.write(path)
        tracing.validate_events(json.loads(path.read_text()))
    names = {e["name"] for e in tracing.to_tracer().to_json()}
    assert set(SERVING) | {"pipeline.step_report"} <= names


def test_nest_orders_marks_and_cuts_an_outlasting_child():
    # "c" (another thread's) ends after "p"; "q" starts where "p" ends.
    records = [("q", None, 30, 40), ("c", "p", 15, 35), ("p", None, 10, 30),
               ("z", "p", 30, 30)]
    assert tracing.nest(records) == [
        (10, True, "p"), (15, True, "c"), (30, False, "c"), (30, False, "p"),
        (30, True, "q"), (30, True, "z"), (30, False, "z"),
        (40, False, "q")]
    assert tracing.nest([]) == []


class _Event:
    """A kineto event's accessors that ``idle_by_span`` reads."""

    def __init__(self, a, b, device="cuda", annotation=False):
        self.a, self.b = a, b
        self.device = getattr(torch.autograd.DeviceType, device.upper())
        self.annotation = annotation

    def start_ns(self):
        return self.a

    def duration_ns(self):
        return self.b - self.a

    def device_type(self):
        return self.device

    def is_user_annotation(self):
        return self.annotation


def test_idle_by_span_splits_gaps_over_the_innermost_span():
    from repro_torch.analysis.profile_window import OUTSIDE, idle_by_span
    records = [("graphs.replay", "runtime.infer_step", 40, 60),
               ("runtime.infer_step", None, 0, 100),
               ("pipeline.step_report", None, 120, 150)]
    # One kernel in [50, 110]; a range's mark on the card and a host
    # event span the window and are not the card's work.
    events = [_Event(50, 110), _Event(-10, 160, annotation=True),
              _Event(-10, 160, device="cpu")]
    idle = idle_by_span(events, records)
    assert idle == pytest.approx({"runtime.infer_step": 40e-9,
                                  "pipeline.step_report": 30e-9,
                                  "graphs.replay": 10e-9, OUTSIDE: 10e-9})
    assert list(idle)[0] == "runtime.infer_step"
    assert idle_by_span(events, []) == {}


@pytest.mark.card
def test_card_spans_counters_and_clock(card):
    """One captured graph on the card under ``device_profile``: the graph
    spans and byte counters, a re-capture counted, and every
    ``runtime.infer_step`` inside the host range around it on kineto's
    clock."""
    from repro_torch.analysis.profile_window import (OUTSIDE, device_profile,
                                                     idle_by_span)
    system, lits, valid = _system(card)
    sess = system.compile(RuntimeSpec(backend="torch", metering="fused",
                                      capacity=B, device=str(card)))
    assert sess.graph("infer_step", B) is not None
    sess.infer_step(lits, valid)      # host operands: a staging copy
    torch.cuda.synchronize()
    assert hasattr(torch.autograd.profiler, "_is_profiler_enabled")
    tracing.reset()
    assert not tracing.recording()
    calls = 3
    with device_profile(cpu=True) as prof:
        on = tracing.recording()
        for _ in range(calls):
            with record_function("host range"):
                res = sess.infer_step(lits, valid)
        torch.cuda.synchronize()
    assert on and not tracing.recording(), torch.__version__
    t = tracing.totals()
    for name in SERVING:
        assert t[name]["count"] == calls, name
    # Each call waits for the previous one's copy out of the staging
    # buffer before writing it.
    assert t["graphs.staging_wait"]["count"] == calls
    assert t["graphs.staging_wait"]["parent"] == "graphs.copy_in"
    in_bytes = sum(int(np.prod(shape)) * dtype.itemsize
                   for shape, dtype in sess.input_specs("infer_step", B))
    out_bytes = sum(x.numel() * x.element_size() for x in (
        res.predictions, res.e_clause_lanes, res.e_class_lanes))
    assert t["graphs.copy_in_bytes"]["count"] == calls * in_bytes
    assert t["graphs.clone_bytes"]["count"] == calls * out_bytes
    events = prof.profiler.kineto_results.events()
    cpu = torch.autograd.DeviceType.CPU
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in events
                    if e.name() == "host range" and e.device_type() == cpu)
    steps = sorted(r[2:] for r in tracing.spans()
                   if r[0] == "runtime.infer_step")
    assert len(ranges) == len(steps) == calls
    for (r0, r1), (s0, s1) in zip(ranges, steps):
        assert r0 - 20_000 <= s0 and s1 <= r1 + 20_000, (r0, r1, s0, s1)
    idle = idle_by_span(events, tracing.spans())
    assert idle and set(idle) <= set(t) | {OUTSIDE}
    assert sum(idle.values()) <= (steps[-1][1] - steps[0][0]) / 1e9
    # A new operand shape: the next call captures again, and counts it.
    system.class_i = torch.cat([system.class_i, torch.zeros(
        (*system.class_i.shape[:2], 1), device=card)], dim=2)
    sess.refresh_operands()
    sess.infer_step(lits, valid)
    assert tracing.totals()["graphs.captures"]["count"] == 1
