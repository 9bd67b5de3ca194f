"""Tenant-aware continuous-batching router: the single-tenant core of
``repro.serve.zoo.ModelZoo``, which ``IMPACTEngine`` is built on.

One tenant owns the whole crossbar grid of one compiled
``InferenceSession``.  ``submit`` enqueues into the tenant's queue
(shedding per its ``SLOClass``); ``step`` admits queued requests into
the free lanes of the slot table, fires at most one sweep when the SLO
class is satisfied, bills every request from the per-lane meters (in
float64, so the bills add up to the batch meter) and releases the lanes.

Co-residency (several tenants packed block-diagonally on one grid), the
standby warm pool, ``rebalance`` and ``replay_zoo_trace`` come with the
co-residency slice.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from ..impact.runtime import InferenceSession
from .engine import Backpressure, BatchingQueue, Request, SlotTable, \
    latency_percentiles
from .impact_engine import BatchStats, RequestRecord, aggregate_reports
from .tracing import PID_REQUESTS, Tracer


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """Service-level class of one tenant: ``priority`` orders admission
    (lower first); ``target_occupancy`` / ``max_wait_s`` are its firing
    policy (fire when occupancy reaches the target or an admitted request
    has waited ``max_wait_s``); ``queue_capacity`` bounds its queue (None =
    unbounded, no shedding)."""
    name: str = "standard"
    priority: int = 1
    target_occupancy: float = 0.0
    max_wait_s: float = 0.01
    queue_capacity: int | None = None

    def __post_init__(self):
        if not 0.0 <= self.target_occupancy <= 1.0:
            raise ValueError(f"target_occupancy must be in [0, 1], "
                             f"got {self.target_occupancy}")
        if self.max_wait_s < 0.0:
            raise ValueError(f"max_wait_s must be >= 0, "
                             f"got {self.max_wait_s}")
        if self.queue_capacity is not None and self.queue_capacity < 0:
            raise ValueError(f"queue_capacity must be >= 0, "
                             f"got {self.queue_capacity}")


@dataclasses.dataclass
class TenantState:
    """One tenant's routing state inside the zoo."""
    tid: str
    slo: SLOClass
    index: int                  # stable registration index
    n_literals: int
    queue: BatchingQueue
    submitted: int = 0
    shed: int = 0
    completed: int = 0
    traffic: float = 0.0        # arrival count (the later rebalance key)


@dataclasses.dataclass
class _ZooLane:
    """Slot-table payload: request + admission timestamp + owning tenant."""
    req: Request
    admitted: float
    tenant: TenantState


class ModelZoo:
    """Continuous-batching router over ONE compiled session (single
    tenant).  ``step()`` returns completed ``(rid, prediction)`` pairs."""

    def __init__(self, session: InferenceSession,
                 tenants: Sequence[tuple[str, SLOClass]], *,
                 clock: Callable[[], float] = time.time,
                 trace: Tracer | None = None):
        if session.capacity is None:
            raise ValueError(
                "ModelZoo needs a session compiled with "
                "RuntimeSpec(capacity=...) — the shared slot-table sweep "
                "shape is fixed at compile time")
        if len(tenants) != 1:
            raise NotImplementedError(
                f"{len(tenants)} tenants need co-residency, which is not "
                f"ported yet (ROADMAP Queue 1, item 10); one tenant owns "
                f"the whole grid")
        self.session = session
        self.clock = clock
        self.capacity = session.capacity
        (tid, slo), = tenants
        t = TenantState(
            tid=tid, slo=slo, index=0,
            n_literals=session.system.n_literals,
            queue=BatchingQueue(max_batch=self.capacity,
                                max_wait_s=slo.max_wait_s, clock=clock))
        self.tenants: list[TenantState] = [t]
        self._by_tid = {tid: t}
        self.table = SlotTable(self.capacity)
        self._lane_lits = np.ones(
            (self.capacity, session.system.n_literals), np.int8)
        self.batch_stats: list[BatchStats] = []
        self.reports: list = []
        self.request_records: list[RequestRecord] = []
        self._next_rid = 0
        self._warm: set[int] = {b for (_, b)
                                in session.compiled_shapes("infer_step")}
        self.resident_sweeps = 0
        self.trace: Tracer | None = None
        self.attach_trace(trace)

    def attach_trace(self, trace: Tracer | None) -> None:
        """Attach (or replace) the Chrome-tracing emitter, re-clocked onto
        the zoo's clock."""
        if trace is not None:
            trace.clock = self.clock
        self.trace = trace

    # -- request plumbing ----------------------------------------------------
    def tenant(self, tid: str) -> TenantState:
        t = self._by_tid.get(tid)
        if t is None:
            raise KeyError(f"unknown tenant {tid!r} "
                           f"(registered: {sorted(self._by_tid)})")
        return t

    @property
    def pending(self) -> int:
        return sum(len(t.queue.pending) for t in self.tenants)

    def submit(self, tid: str, literals: np.ndarray) -> int:
        """Enqueue one (K,) literal vector for tenant ``tid``; returns the
        request id.  Raises ``ValueError`` on a mis-shaped request and
        ``Backpressure`` past ``slo.queue_capacity`` + free lanes."""
        t = self.tenant(tid)
        lits = np.asarray(literals)
        if lits.shape != (t.n_literals,):
            raise ValueError(
                f"literals shape {lits.shape} does not match tenant "
                f"{tid!r}'s compiled request shape ({t.n_literals},)")
        cap = t.slo.queue_capacity
        if cap is not None and len(t.queue.pending) >= cap + self.table.free:
            raise Backpressure(
                f"tenant {tid!r}: {self.table.occupancy}/"
                f"{self.table.capacity} slots busy and "
                f"{len(t.queue.pending)} requests queued "
                f"(queue_capacity={cap})")
        t.submitted += 1
        t.traffic += 1.0
        rid = self._next_rid
        self._next_rid += 1
        t.queue.add(Request(rid, lits.astype(np.int8), max_new=0,
                            arrived=self.clock()))
        return rid

    def try_submit(self, tid: str, literals: np.ndarray) -> int | None:
        try:
            return self.submit(tid, literals)
        except Backpressure:
            self.tenant(tid).shed += 1
            return None

    def warmup(self) -> None:
        """Prepare the sweep shape (usually already done at session
        build)."""
        self.session.warm(self.capacity)
        self._warm.add(self.capacity)

    # -- scheduling ----------------------------------------------------------
    def _should_fire(self, now: float, occ: int) -> bool:
        # Fire when an admitted lane's SLO class is satisfied: occupancy
        # target met (a full table always fires) or it has waited its
        # class's max_wait_s since admission.
        for _, lane in self.table.occupied():
            slo = lane.tenant.slo
            if occ >= self.capacity * slo.target_occupancy:
                return True
            if (now - lane.admitted) >= slo.max_wait_s:
                return True
        return False

    def step(self, *, force: bool = False) -> list[tuple[int, int]]:
        """One scheduler iteration; ``force`` fires below the SLO
        thresholds (tail drain)."""
        return self._step_resident(force)

    def _step_resident(self, force: bool) -> list[tuple[int, int]]:
        now = self.clock()
        admitted = []
        for t in self.tenants:
            free = self.table.free
            if free == 0:
                break
            for req in t.queue.take_n(free):
                s = self.table.admit(_ZooLane(req, now, t))
                self._lane_lits[s] = req.tokens
                admitted.append(s)
        if admitted and self.trace is not None:
            self.trace.span("admission", now, self.clock(), args=dict(
                lanes=admitted, occupancy=self.table.occupancy))
        occ = self.table.occupancy
        if occ == 0:
            return []
        if not (force or self._should_fire(now, occ)):
            return []
        lanes = list(self.table.occupied())
        out = self.execute_batch(self._lane_lits, self.table.valid_mask(),
                                 self.capacity, lanes)
        t_rel = self.clock()
        for i, _ in lanes:
            self.table.release(i)
            self._lane_lits[i] = 1
        if self.trace is not None:
            self.trace.span("release", t_rel, self.clock(), args=dict(
                lanes=[i for i, _ in lanes],
                occupancy=self.table.occupancy))
        return out

    # -- execution -----------------------------------------------------------
    def execute_batch(self, lits: np.ndarray, valid: np.ndarray, shape: int,
                      lanes: list[tuple[int, _ZooLane]],
                      ) -> list[tuple[int, int]]:
        """Fire one sweep of the session over ``shape`` lanes (also the
        flush-mode entry of the engine)."""
        cold = shape not in self._warm
        self._warm.add(shape)
        return self._run_sweep(self.session, lits, valid, shape, lanes,
                               cold=cold)

    def _run_sweep(self, session: InferenceSession, lits: np.ndarray,
                   valid: np.ndarray, shape: int,
                   lanes: list[tuple[int, _ZooLane]], *,
                   cold: bool) -> list[tuple[int, int]]:
        """One crossbar sweep + all per-step accounting (ledgers, energy
        billing, trace spans)."""
        occupancy = len(lanes) / shape
        t0 = self.clock()
        if self.trace is not None:
            self.trace.begin("sweep", ts=t0, args=dict(
                shape=shape, n_valid=len(lanes), occupancy=occupancy,
                cold=cold, lanes=[i for i, _ in lanes]))
        res = session.infer_step(torch.from_numpy(lits), valid)
        preds = res.predictions.cpu().numpy()
        # float64 before the per-request clause+class add so the request
        # bills sum to the (float64) batch meter, not to f32 rounding.
        e_cl = res.e_clause_lanes.cpu().numpy().astype(np.float64)
        e_cs = res.e_class_lanes.cpu().numpy().astype(np.float64)
        t1 = self.clock()
        dt = t1 - t0
        if self.trace is not None:
            self.trace.end("sweep", ts=t1)
            self.trace.begin("billing", ts=t1,
                             args=dict(n_requests=len(lanes)))
        recs = [RequestRecord(
            rid=lane.req.rid, arrived=lane.req.arrived,
            admitted=lane.admitted, completed=t1, pred=int(preds[i]),
            e_read_j=float(e_cl[i] + e_cs[i]),
            tenant=lane.tenant.tid) for i, lane in lanes]
        self.request_records.extend(recs)
        for _, lane in lanes:
            lane.tenant.completed += 1
        pct = latency_percentiles([r.latency_s for r in recs])
        self.batch_stats.append(BatchStats(
            bucket=shape, n_valid=len(recs), latency_s=dt,
            samples_per_s=len(recs) / max(dt, 1e-9), cold=cold,
            occupancy=occupancy,
            p50_s=pct.get("p50_s", 0.0), p95_s=pct.get("p95_s", 0.0),
            p99_s=pct.get("p99_s", 0.0)))
        self.resident_sweeps += 1
        if session.meters_energy:
            self.reports.append(session.system.step_report(e_cl, e_cs,
                                                           len(recs)))
        if self.trace is not None:
            t2 = self.clock()
            self.trace.end("billing", ts=t2)
            for (i, lane), r in zip(lanes, recs):
                self.trace.request_spans(
                    rid=r.rid, arrived=r.arrived, admitted=r.admitted,
                    sweep_start=t0, sweep_end=t1, billed=t2, lane=i,
                    shape=shape, pid=PID_REQUESTS,
                    args=dict(e_read_j=r.e_read_j, pred=r.pred,
                              tenant=r.tenant))
        return [(r.rid, r.pred) for r in recs]

    # -- aggregation ---------------------------------------------------------
    def drain(self) -> list[tuple[int, int]]:
        """Step until every queue and the slot table are empty (forcing
        once nothing more can batch up)."""
        out: list[tuple[int, int]] = []
        while self.pending or self.table.occupancy:
            out += self.step(force=not any(t.queue.ready()
                                           for t in self.tenants
                                           if t.queue.pending))
        return out

    def stats(self) -> dict:
        """Lifetime aggregates plus per-tenant and per-SLO-class
        breakdowns (latency percentiles, energy bills, shed counts)."""
        bs = self.batch_stats
        warm = [s for s in bs if not s.cold] or bs
        w_total = sum(s.n_valid for s in warm)
        w_wall = sum(s.latency_s for s in warm)
        out = dict(
            tenants=len(self.tenants),
            resident=[t.tid for t in self.tenants],
            standby=[],
            batches=len(bs), samples=sum(s.n_valid for s in bs),
            wall_s=sum(s.latency_s for s in bs),
            cold_batches=sum(s.cold for s in bs),
            samples_per_s=w_total / max(w_wall, 1e-9),
            mean_occupancy=(sum(s.occupancy for s in bs) / len(bs)
                            if bs else 0.0),
            sweeps=dict(resident=self.resident_sweeps, standby=0),
        )
        recs = self.request_records
        if recs:
            out["latency"] = latency_percentiles(
                [r.latency_s for r in recs])
        if self.reports:
            agg = aggregate_reports(self.reports)
            out["energy"] = agg
            out["energy_per_datapoint_j"] = agg.energy_per_datapoint_j
        by_tenant = {}
        for t in self.tenants:
            t_recs = [r for r in recs if r.tenant == t.tid]
            d = dict(slo=t.slo.name, resident=True,
                     submitted=t.submitted, shed=t.shed,
                     completed=len(t_recs),
                     e_read_j=float(sum(r.e_read_j for r in t_recs)))
            if t_recs:
                d["latency"] = latency_percentiles(
                    [r.latency_s for r in t_recs])
            by_tenant[t.tid] = d
        out["per_tenant"] = by_tenant
        out["per_slo"] = {
            t.slo.name: dict(priority=t.slo.priority, **latency_percentiles(
                [r.latency_s for r in recs if r.tenant == t.tid]))
            for t in self.tenants
            if any(r.tenant == t.tid for r in recs)}
        return out
