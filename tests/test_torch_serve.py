"""The port's serving front (``IMPACTEngine`` on its single-tenant zoo, the
slot table, the queue, tracing) against the JAX engine on a virtual clock.

Both engines serve the same system and the same request stream with the
same clock, so the same requests land in the same sweeps: predictions are
exact, per-request bills agree at rtol 1e-5, and in each engine the
float64 sum of the bills equals the batch meter (rel 1e-9).
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.impact import IMPACTConfig as JConfig
from repro.impact import RuntimeSpec as JSpec
from repro.impact.pipeline import IMPACTSystem as JSystem
from repro.serve import IMPACTEngine as JEngine
from repro.serve import Tracer as JTracer
from repro.serve import engine as jengine
from repro.serve import poisson_arrivals as j_poisson
from repro_torch.convert import system_from_arrays
from repro_torch.impact import RuntimeSpec
from repro_torch.impact.yflash import read_current
from repro_torch.serve import (Backpressure, BatchingQueue, IMPACTEngine,
                               Request, SlotTable, Tracer, aggregate_reports,
                               latency_percentiles, poisson_arrivals,
                               replay_trace, validate_events)

K, N, M, R, TR, C, TC, S, SR = 120, 40, 6, 2, 64, 2, 24, 2, 32


class VirtualClock:
    """Deterministic time source: every reading advances 0.5 ms."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 5e-4
        return self.t


@pytest.fixture(scope="module")
def systems():
    rng = np.random.default_rng(0)
    include = rng.random((R * TR, C * TC)) < 0.04
    include[K:, :] = False
    include[:, N:] = False
    g = np.where(include,
                 2.5e-6 * (1 + 0.05 * rng.standard_normal(include.shape)),
                 0.9e-9 * (1 + 0.05 * rng.standard_normal(include.shape)))
    clause_g = np.ascontiguousarray(
        g.reshape(R, TR, C, TC).transpose(0, 2, 1, 3), np.float32)
    wg = rng.uniform(1e-9, 2.5e-6, (S, SR, M))
    wg *= (np.arange(S * SR).reshape(S, SR, 1) < N)
    class_g = wg.astype(np.float32)
    d = dict(clause_g=clause_g, class_g=class_g,
             clause_i=read_current(torch.from_numpy(clause_g)).numpy(),
             class_i=read_current(torch.from_numpy(class_g)).numpy(),
             nonempty=include[:, :C * TC].any(axis=0), n_literals=K,
             n_clauses=N, n_classes=M, program_energy_j=1e-3,
             erase_energy_j=1e-9)
    jsys = JSystem(
        **{k: jnp.asarray(d[k]) for k in ("clause_g", "nonempty", "class_g",
                                          "clause_i", "class_i")},
        n_literals=K, n_clauses=N, n_classes=M, cfg=JConfig(),
        encode_stats=dict(program_energy_j=1e-3, erase_energy_j=1e-9))
    lits = rng.random((70, K)) < 0.5
    return jsys, system_from_arrays(d, device="cpu"), lits


def _bill_identity(eng):
    bills = sum(r.e_read_j for r in eng.request_records)
    meter = aggregate_reports(eng.reports).read_energy_j
    assert bills > 0
    assert abs(bills - meter) <= 1e-9 * abs(meter)


@pytest.mark.parametrize("mode,kw", [
    ("continuous", dict(target_occupancy=0.5, max_wait_s=2e-3)),
    ("flush", dict(buckets=(4, 8), max_wait_s=2e-3)),
])
@pytest.mark.parametrize("metering", ["staged", "fused"])
def test_engine_matches_jax_on_virtual_clock(systems, mode, kw, metering):
    jsys, tsys, lits = systems
    trace = Tracer()
    t_eng = IMPACTEngine(
        tsys.compile(RuntimeSpec(metering=metering, capacity=16,
                                 device="cpu")),
        mode=mode, clock=VirtualClock(), trace=trace, **kw)
    j_eng = JEngine(jsys.compile(JSpec(backend="xla", metering=metering,
                                       capacity=16)),
                    mode=mode, clock=VirtualClock(), trace=JTracer(), **kw)
    p_t, s_t = t_eng.run(lits)
    p_j, s_j = j_eng.run(lits)
    np.testing.assert_array_equal(p_t, p_j)
    assert [b.n_valid for b in t_eng.batch_stats] == \
        [b.n_valid for b in j_eng.batch_stats]
    assert s_t["batches"] == s_j["batches"]
    assert s_t["buckets_used"] == s_j["buckets_used"]
    rec_t = {r.rid: r for r in t_eng.request_records}
    for r in j_eng.request_records:
        mine = rec_t[r.rid]
        assert mine.pred == r.pred
        assert mine.latency_s == pytest.approx(r.latency_s, rel=1e-12)
        np.testing.assert_allclose(mine.e_read_j, r.e_read_j, rtol=1e-5)
    _bill_identity(t_eng)
    np.testing.assert_allclose(s_t["energy"].read_energy_j,
                               s_j["energy"].read_energy_j, rtol=1e-5)
    assert s_t["energy"].datapoints == lits.shape[0]
    events = trace.to_json()
    validate_events(events)
    j_events = j_eng.trace.to_json()
    assert len(events) == len(j_events)
    for e, je in zip(events, j_events):
        # Same timeline span for span; the bills ride the args at rtol 1e-5.
        bill, j_bill = (x.get("args", {}).get("e_read_j") for x in (e, je))
        strip = lambda x: {**x, "args": {k: v for k, v in x.get(
            "args", {}).items() if k != "e_read_j"}}
        assert strip(e) == strip(je)
        if bill is not None:
            np.testing.assert_allclose(bill, j_bill, rtol=1e-5)
    json.dumps(events)
    names = {e["name"] for e in events}
    assert {"sweep", "billing", "queued", "admitted", "billed"} <= names
    assert ("release" in names) == (mode == "continuous")


def test_unmetered_engine_bills_nothing(systems):
    _, tsys, lits = systems
    eng = IMPACTEngine(tsys.compile(RuntimeSpec(metering="off", capacity=16,
                                                device="cpu")),
                       clock=VirtualClock())
    staged = IMPACTEngine(tsys.compile(RuntimeSpec(capacity=16,
                                                   device="cpu")),
                          clock=VirtualClock())
    p_off, s_off = eng.run(lits)
    p_st, _ = staged.run(lits)
    np.testing.assert_array_equal(p_off, p_st)
    assert "energy" not in s_off and eng.reports == []
    assert all(r.e_read_j == 0.0 for r in eng.request_records)


def test_engine_validation_and_backpressure(systems):
    _, tsys, lits = systems
    sess = tsys.compile(RuntimeSpec(capacity=4, device="cpu"))
    with pytest.raises(ValueError, match="buckets"):
        IMPACTEngine(sess, buckets=(2,))
    with pytest.raises(ValueError, match="target_occupancy"):
        IMPACTEngine(sess, mode="flush", target_occupancy=0.5)
    with pytest.raises(ValueError, match="capacity"):
        IMPACTEngine(tsys.compile(RuntimeSpec(device="cpu")))
    with pytest.raises(ValueError, match="max_batch"):
        IMPACTEngine(sess, max_batch=8)
    eng = IMPACTEngine(sess, queue_capacity=2, clock=VirtualClock())
    with pytest.raises(ValueError, match="shape"):
        eng.submit(lits[0][:-1])
    for row in lits[:6]:                 # 4 free lanes + 2 queued
        eng.submit(row)
    with pytest.raises(Backpressure):
        eng.submit(lits[6])
    assert eng.try_submit(lits[6]) is None
    assert len(eng.step(force=True)) == 4
    assert eng._zoo.drain() and eng.table.occupancy == 0
    st = eng._zoo.stats()
    assert st["per_tenant"]["default"]["completed"] == 6
    assert st["sweeps"] == dict(resident=2, standby=0)
    auto = IMPACTEngine(tsys, max_batch=8)
    assert auto.session.spec == RuntimeSpec(capacity=8, device="cpu")


def test_scheduling_primitives_match_jax():
    cap = 5
    ours, theirs = SlotTable(cap), jengine.SlotTable(cap)
    for op in ["a0", "a1", "a2", "r1", "a3", "r0", "a4", "a5", "c", "r2"]:
        if op[0] == "a":
            assert ours.admit(op) == theirs.admit(op)
        elif op[0] == "r":
            i = int(op[1])
            assert ours.release(i) == theirs.release(i)
        else:
            assert ours.compact() == theirs.compact()
        np.testing.assert_array_equal(ours.valid_mask(),
                                      theirs.valid_mask())
        assert ours.free_slots() == theirs.free_slots()
    with pytest.raises(KeyError):
        ours.release(4)
    lat = list(np.random.default_rng(1).exponential(1e-3, 200))
    assert latency_percentiles(lat) == jengine.latency_percentiles(lat)
    assert latency_percentiles([]) == {}
    np.testing.assert_array_equal(poisson_arrivals(100, 250.0, seed=3),
                                  j_poisson(100, 250.0, seed=3))
    with pytest.raises(ValueError):
        poisson_arrivals(3, 0.0)

    clock = VirtualClock()
    q = BatchingQueue(max_batch=3, max_wait_s=1e-2, clock=clock)
    reqs = [Request(i, np.arange(i + 1, dtype=np.int32), 0, arrived=clock())
            for i in range(4)]
    for r in reqs:
        q.add(r)
    assert q.ready()
    assert [r.rid for r in q.take()] == [0, 1, 2]
    toks, mask = BatchingQueue.pad(reqs[:3])
    jt, jm = jengine.BatchingQueue.pad(
        [jengine.Request(r.rid, r.tokens, 0) for r in reqs[:3]])
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
    assert [r.rid for r in q.take_n(5)] == [3]


def test_replay_trace_needs_a_wall_clock(systems, tmp_path):
    _, tsys, lits = systems
    sess = tsys.compile(RuntimeSpec(capacity=16, device="cpu"))
    frozen = IMPACTEngine(sess, clock=lambda: 0.0, max_wait_s=1.0,
                          target_occupancy=1.0)
    with pytest.raises(RuntimeError, match="wall clock"):
        replay_trace(frozen, lits, np.ones(2))
    eng = IMPACTEngine(sess)
    path = tmp_path / "replay.trace.json"
    out = replay_trace(eng, lits, poisson_arrivals(40, 4000.0, seed=0),
                       trace_path=str(path))
    assert out["completed"] == 40 and out["shed"] == 0
    validate_events(json.loads(path.read_text()))
    with pytest.raises(ValueError, match="one literal row"):
        replay_trace(eng, lits[:2], np.zeros(3))


def test_aggregate_reports_sums_windows(systems):
    _, tsys, lits = systems
    eng = IMPACTEngine(tsys.compile(RuntimeSpec(capacity=16, device="cpu")),
                       clock=VirtualClock())
    eng.run(lits)
    agg = aggregate_reports(eng.reports)
    assert agg.datapoints == lits.shape[0]
    assert agg.latency_s == pytest.approx(
        sum(r.latency_s for r in eng.reports))
    assert agg.area_mm2 is None
    assert dataclasses.replace(agg, write_energy_j=0.0) == agg
    with pytest.raises(ValueError):
        aggregate_reports([])
