"""The port's multi-tenant model zoo (``repro_torch.serve.ModelZoo`` over a
co-resident session, the standby warm pool, ``rebalance``,
``replay_zoo_trace``) held against the JAX reference: the twins of the
zoo tests in ``tests/test_model_zoo.py``.

The members are the reference's own small single-tile systems carried
across as arrays (``test_torch_coresident.members``); the port's zoo runs
on CPU tensors, and every prediction it returns is held to what the
reference's standalone ``"xla"`` session of that tenant predicts.  One
test serves the same stream through the JAX zoo and the port's on one
fake clock: the same requests land in the same sweeps, predictions are
exact and per-request bills agree at rtol 1e-3 (the clause meter's).
"""
import json
import time

import jax.numpy as jnp
import numpy as np
import pytest

from repro.impact import RuntimeSpec as JSpec
from repro.serve import ModelZoo as JZoo
from repro.serve import SLOClass as JSLO
from repro_torch.impact import RuntimeSpec, build_coresident
from repro_torch.serve import (Backpressure, IMPACTEngine, ModelZoo,
                               SLOClass, Tracer, poisson_arrivals,
                               replay_zoo_trace, validate_events)
from repro_torch.tracing import PID_REQUESTS, PID_TENANT_BASE

from test_torch_coresident import members


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def standalone_pred(jsys, row):
    """What the reference's standalone session of the tenant predicts."""
    sess = jsys.compile(JSpec(backend="xla", metering="staged", capacity=1))
    return int(np.asarray(sess.predict(jnp.asarray(row[None, :]))
                          .predictions)[0])


def random_rows(systems, rng):
    return [rng.integers(0, 2, size=s.n_literals).astype(np.int8)
            for s in systems]


def make_zoo(n_tenants=3, *, capacity=6, clock=None, trace=None, slos=None,
             max_resident=None, standby_capacity=4, standby_pool=2,
             backend="torch", metering="staged"):
    js, ts = members(n_tenants, density=0.05)
    if slos is None:
        slos = [SLOClass(name="standard", priority=1, max_wait_s=0.0)
                for _ in ts]
    zoo = ModelZoo.build(
        [(f"t{i}", s, slo) for i, (s, slo) in enumerate(zip(ts, slos))],
        RuntimeSpec(backend=backend, metering=metering, device="cpu"),
        capacity=capacity, max_resident=max_resident,
        standby_capacity=standby_capacity, standby_pool=standby_pool,
        clock=clock if clock is not None else time.monotonic, trace=trace)
    return zoo, js, ts


def never_fires():
    return SLOClass(name="bulk", priority=1, target_occupancy=1.0,
                    max_wait_s=10.0)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_zoo_serves_all_tenants_with_parity(backend):
    zoo, js, ts = make_zoo(3, backend=backend)
    assert zoo.session.coresident is zoo.plan and zoo.plan.n_tenants == 3
    rng = np.random.default_rng(2)
    want = {}
    for _ in range(3):
        for t, row in zip(zoo.tenants, random_rows(ts, rng)):
            want[zoo.submit(t.tid, row)] = standalone_pred(js[t.index], row)
    got = dict(zoo.drain())
    assert got == want
    st = zoo.stats()
    assert st["sweeps"]["standby"] == 0
    assert st["resident"] == ["t0", "t1", "t2"] and st["standby"] == []
    for t in zoo.tenants:
        assert st["per_tenant"][t.tid]["completed"] == 3


def test_zoo_matches_jax_zoo_on_one_clock():
    """The same stream through the reference's zoo and the port's, each on
    a fake clock advanced the same way: the same sweeps, the same
    predictions, per-request bills at the clause meter's rtol."""
    js, ts = members(3, density=0.05)
    slos = [("gold", 0, 0.0), ("standard", 1, 0.5), ("standard", 1, 0.5)]

    def build(zoo_cls, slo_cls, systems, spec, clock):
        return zoo_cls.build(
            [(f"t{i}", s, slo_cls(name=n, priority=p, target_occupancy=o,
                                  max_wait_s=0.002))
             for i, (s, (n, p, o)) in enumerate(zip(systems, slos))],
            spec, capacity=4, clock=clock)

    jclk, tclk = FakeClock(), FakeClock()
    jzoo = build(JZoo, JSLO, js, JSpec(backend="xla", metering="staged"),
                 jclk)
    tzoo = build(ModelZoo, SLOClass, ts,
                 RuntimeSpec(backend="torch", metering="staged",
                             device="cpu"), tclk)
    rng = np.random.default_rng(12)
    jdone, tdone = {}, {}
    for step in range(30):
        for _ in range(int(rng.integers(0, 4))):
            t = int(rng.integers(3))
            row = rng.integers(0, 2, size=ts[t].n_literals).astype(np.int8)
            assert jzoo.submit(f"t{t}", row) == tzoo.submit(f"t{t}", row)
        jclk.t += 0.001
        tclk.t += 0.001
        jdone.update(jzoo.step())
        tdone.update(tzoo.step())
    jdone.update(jzoo.drain())
    tdone.update(tzoo.drain())
    assert tdone == jdone and len(tdone) > 20
    assert tzoo.resident_sweeps == jzoo.resident_sweeps
    jrec = {r.rid: r for r in jzoo.request_records}
    for r in tzoo.request_records:
        w = jrec[r.rid]
        assert (r.tenant, r.pred, r.admitted, r.completed) == (
            w.tenant, w.pred, w.admitted, w.completed)
        np.testing.assert_allclose(r.e_read_j, w.e_read_j, rtol=1e-3)
    assert tzoo.stats()["per_slo"].keys() == jzoo.stats()["per_slo"].keys()


def test_zoo_priority_orders_admission():
    clk = FakeClock()
    gold = SLOClass(name="gold", priority=0, max_wait_s=0.0)
    std = SLOClass(name="standard", priority=1, max_wait_s=0.0)
    # capacity 2 < offered 3: the gold tenant wins a lane although it
    # registered (and submitted) last.
    zoo, js, ts = make_zoo(3, capacity=2, clock=clk, slos=[std, std, gold])
    rng = np.random.default_rng(3)
    for t, row in zip(zoo.tenants, random_rows(ts, rng)):
        zoo.submit(t.tid, row)
    done = zoo.step(force=True)
    assert len(done) == 2
    assert "t2" in {r.tenant for r in zoo.request_records[-2:]}
    assert len(zoo.step(force=True)) == 1       # the standard leftover


def test_zoo_slo_firing_policy():
    clk = FakeClock()
    gold = SLOClass(name="gold", priority=0, max_wait_s=0.0)
    zoo, js, ts = make_zoo(2, capacity=6, clock=clk,
                           slos=[never_fires(), gold])
    rows = random_rows(ts, np.random.default_rng(4))
    # A lone bulk request neither meets its occupancy target nor goes
    # stale: the sweep defers.
    zoo.submit("t0", rows[0])
    assert zoo.step() == []
    assert zoo.table.occupancy == 1
    # One gold arrival satisfies its class: the shared sweep fires and
    # carries the bulk lane along.
    zoo.submit("t1", rows[1])
    assert len(zoo.step()) == 2
    # A deferred bulk lane fires once it has waited its max_wait_s.
    zoo.submit("t0", rows[0])
    assert zoo.step() == []
    clk.t += 10.0
    assert len(zoo.step()) == 1


def test_zoo_per_tenant_shed_isolation():
    clk = FakeClock()
    bounded = SLOClass(name="bounded", priority=1, max_wait_s=10.0,
                       target_occupancy=1.0, queue_capacity=1)
    zoo, js, ts = make_zoo(2, capacity=3, clock=clk,
                           slos=[bounded, never_fires()])
    row0, row1 = random_rows(ts[:2], np.random.default_rng(5))
    # Partly fill the shared table with the unbounded tenant.
    zoo.submit("t1", row1)
    zoo.submit("t1", row1)
    zoo.step()                                  # admits, defers
    assert zoo.table.free == 1
    # The bounded tenant absorbs queue_capacity + free lanes = 2 ...
    assert zoo.try_submit("t0", row0) is not None
    assert zoo.try_submit("t0", row0) is not None
    with pytest.raises(Backpressure):
        zoo.submit("t0", row0)
    # ... while the unbounded tenant keeps queueing.
    assert zoo.try_submit("t1", row1) is not None
    assert zoo.tenant("t0").shed == 0           # the raise does not count
    assert zoo.try_submit("t0", row0) is None
    assert zoo.tenant("t0").shed == 1


def test_zoo_submit_validates_shape_and_tenant():
    zoo, js, ts = make_zoo(2)
    with pytest.raises(KeyError, match="unknown tenant"):
        zoo.submit("nope", np.ones((ts[0].n_literals,), np.int8))
    with pytest.raises(ValueError, match="shape"):
        zoo.submit("t0", np.ones((ts[0].n_literals + 1,), np.int8))
    with pytest.raises(ValueError, match="duplicate"):
        zoo.add_standby("t0", ts[0], SLOClass())


def test_zoo_construction_checks():
    js, ts = members(2, density=0.05)
    combined, plan = build_coresident(ts)
    co = combined.compile(RuntimeSpec(backend="torch", capacity=4,
                                      coresident=plan, device="cpu"))
    with pytest.raises(ValueError, match="do not match"):
        ModelZoo(co, [("a", SLOClass())])
    plain = ts[0].compile(RuntimeSpec(backend="torch", capacity=4,
                                      device="cpu"))
    with pytest.raises(ValueError, match="CoResidentPlan"):
        ModelZoo(plain, [("a", SLOClass()), ("b", SLOClass())])
    unsized = ts[0].compile(RuntimeSpec(backend="torch", device="cpu"))
    with pytest.raises(ValueError, match="capacity"):
        ModelZoo(unsized, [("a", SLOClass())])
    with pytest.raises(ValueError, match="at least one tenant"):
        ModelZoo.build([], RuntimeSpec(device="cpu"), capacity=4)
    with pytest.raises(ValueError, match="slot-table shape"):
        ModelZoo.build([("a", ts[0], SLOClass())],
                       RuntimeSpec(device="cpu"))
    zoo = ModelZoo(co, [("a", SLOClass()), ("b", SLOClass())])
    assert [t.model_id for t in zoo.tenants] == [0, 1]
    assert zoo.tenant("b").lit_lo == plan.spans[1].lit_lo
    assert zoo.rebalance() is False             # no member systems


@pytest.mark.parametrize("metering", ["staged", "fused"])
def test_zoo_billing_is_tenant_pure(metering):
    zoo, js, ts = make_zoo(3, metering=metering)
    rng = np.random.default_rng(6)
    for _ in range(4):
        for t, row in zip(zoo.tenants, random_rows(ts, rng)):
            zoo.submit(t.tid, row)
        zoo.drain()
    st = zoo.stats()
    bill = sum(v["e_read_j"] for v in st["per_tenant"].values())
    meter = st["energy"].read_energy_j
    assert abs(bill - meter) <= 1e-9 * abs(meter)
    assert all(v["e_read_j"] > 0 for v in st["per_tenant"].values())


def test_zoo_trace_per_tenant_tracks(tmp_path):
    clk = FakeClock()
    tr = Tracer(clock=clk)
    zoo, js, ts = make_zoo(3, clock=clk, trace=tr)
    for t, row in zip(zoo.tenants, random_rows(ts, np.random.default_rng(7))):
        clk.t += 0.001
        zoo.submit(t.tid, row)
    clk.t += 0.001
    zoo.step(force=True)
    events = tr.to_json()
    validate_events(events)
    pids = {e["pid"] for e in events if e.get("ph") != "M"}
    assert {PID_TENANT_BASE + t.index for t in zoo.tenants} <= pids
    assert PID_REQUESTS not in pids
    names = {e["args"]["name"] for e in events
             if e.get("ph") == "M" and e["name"] == "process_name"}
    assert {"tenant t0", "tenant t1", "tenant t2"} <= names


def test_zoo_standby_serving_and_promotion():
    zoo, js, ts = make_zoo(4, capacity=6, max_resident=2,
                           standby_capacity=4, standby_pool=1)
    assert [t.tid for t in zoo.tenants if t.resident] == ["t0", "t1"]
    assert zoo.plan.n_tenants == 2
    rows = random_rows(ts, np.random.default_rng(8))
    # Standby tenants answer from their dedicated sessions.
    for tid, i in (("t2", 2), ("t3", 3)):
        rid = zoo.submit(tid, rows[i])
        assert dict(zoo.drain())[rid] == standalone_pred(js[i], rows[i])
    assert zoo.stats()["sweeps"]["standby"] == 2
    assert zoo._standby_sessions["t3"].capacity == 4
    # A pool of one: serving t3 evicted t2's session.
    assert set(zoo._standby_sessions) == {"t3"}
    # Heavy t2 traffic, then rebalance: t2 joins the resident set.
    for _ in range(20):
        zoo.submit("t2", rows[2])
        zoo.drain()
    assert zoo.rebalance() is True
    assert zoo.tenant("t2").resident
    # t2 (21 arrivals) and t3 (1) outrank t0 and t1 (none).
    assert [t.tid for t in zoo.tenants if t.resident] == ["t2", "t3"]
    assert zoo.session.coresident is zoo.plan
    assert "t2" not in zoo._standby_sessions
    for i in range(4):
        rid = zoo.submit(f"t{i}", rows[i])
        assert dict(zoo.drain())[rid] == standalone_pred(js[i], rows[i])


def test_zoo_rebalance_requires_idle_table():
    clk = FakeClock()
    zoo, js, ts = make_zoo(3, capacity=6, max_resident=2, clock=clk,
                           slos=[never_fires()] * 3)
    rows = random_rows(ts, np.random.default_rng(9))
    for _ in range(8):
        zoo.submit("t2", rows[2])
    zoo.step(force=True)
    zoo.submit("t0", rows[0])
    zoo.step()                                  # admitted, sweep deferred
    assert zoo.table.occupancy == 1
    with pytest.raises(RuntimeError, match="idle"):
        zoo.rebalance()
    zoo.step(force=True)
    assert zoo.rebalance() is True


def test_zoo_failed_rebalance_preserves_traffic():
    """A busy-table rebalance raises before it decays any traffic EWMA,
    so a retry ranks on the same counters; a rebalance that changes
    nothing still decays them."""
    clk = FakeClock()
    zoo, js, ts = make_zoo(3, capacity=6, max_resident=2, clock=clk,
                           slos=[never_fires()] * 3)
    rows = random_rows(ts, np.random.default_rng(10))
    for _ in range(8):
        zoo.submit("t2", rows[2])
    zoo.step(force=True)
    zoo.submit("t0", rows[0])
    zoo.step()
    before = {t.tid: t.traffic for t in zoo.tenants}
    with pytest.raises(RuntimeError, match="idle"):
        zoo.rebalance()
    assert {t.tid: t.traffic for t in zoo.tenants} == before
    zoo.step(force=True)
    assert zoo.rebalance() is True
    after = {t.tid: t.traffic for t in zoo.tenants}
    assert zoo.rebalance() is False
    assert all(t.traffic < after[t.tid] or after[t.tid] == 0.0
               for t in zoo.tenants)


def test_zoo_coresident_fewer_sweeps_than_per_tenant_engines():
    n_tenants, reps = 4, 3
    zoo, js, ts = make_zoo(n_tenants)
    rng = np.random.default_rng(10)
    for _ in range(reps):
        for t, row in zip(zoo.tenants, random_rows(ts, rng)):
            zoo.submit(t.tid, row)
        zoo.drain()
    # One shared sweep a round against one sweep a tenant a round.
    assert zoo.resident_sweeps == reps
    assert zoo.resident_sweeps < n_tenants * reps


def test_replay_zoo_trace_mixed_traffic(tmp_path):
    zoo, js, ts = make_zoo(3)
    rng = np.random.default_rng(11)
    n = 24
    reqs = []
    for _ in range(n):
        t = zoo.tenants[int(rng.integers(len(zoo.tenants)))]
        reqs.append((t.tid, rng.integers(0, 2, size=t.n_literals)
                     .astype(np.int8)))
    path = tmp_path / "zoo.trace.json"
    out = replay_zoo_trace(zoo, reqs, poisson_arrivals(n, 400.0, seed=1),
                           trace_path=str(path))
    assert out["completed"] + out["shed"] == n
    assert out["zoo"]["per_tenant"].keys() == {"t0", "t1", "t2"}
    assert out["trace_path"] == str(path)
    validate_events(json.loads(path.read_text()))
    got = {r.rid: r.pred for r in zoo.request_records}
    for rid, (tid, row) in enumerate(reqs):
        assert got[rid] == standalone_pred(js[int(tid[1:])], row)
    with pytest.raises(ValueError, match="one request per arrival"):
        replay_zoo_trace(zoo, reqs[:2], np.zeros(3))


def test_replay_zoo_trace_frozen_clock_raises():
    clk = FakeClock()
    zoo, js, ts = make_zoo(2, clock=clk)
    reqs = [("t0", np.ones((ts[0].n_literals,), np.int8))] * 2
    for t in zoo.tenants:
        t.slo = never_fires()              # the replay loop must idle
    with pytest.raises(RuntimeError, match="time.monotonic"):
        replay_zoo_trace(zoo, reqs, np.array([0.0, 10.0]))


def test_engine_is_one_tenant_zoo():
    _, (system,) = members(1, density=0.05)
    eng = IMPACTEngine(system.compile(RuntimeSpec(
        backend="torch", metering="staged", capacity=4, device="cpu")))
    assert len(eng._zoo.tenants) == 1 and eng._zoo.plan is None
    assert eng._zoo.tenants[0].slo.name == "default"
    assert eng._zoo.tenants[0].resident
    rid = eng.submit(np.ones((system.n_literals,), np.int8))
    assert rid == 0
    (rid2, _), = eng.step(force=True)
    assert rid2 == rid
    assert eng.request_records[0].tenant == "default"
    assert eng._zoo.standby_sweeps == 0


def test_engine_rejects_coresident_session():
    _, ts = members(2, density=0.05)
    combined, plan = build_coresident(ts)
    sess = combined.compile(RuntimeSpec(backend="torch", capacity=4,
                                        coresident=plan, device="cpu"))
    with pytest.raises(ValueError, match="ModelZoo"):
        IMPACTEngine(sess)
