"""Multi-tenant model zoo: a tenant-aware continuous-batching router over
shared crossbars (the PyTorch port of ``repro.serve.zoo``).

* **Crossbar co-residency.**  Resident tenants' grids are packed
  block-diagonally onto one shared grid (``impact.runtime.
  build_coresident``) and served by one co-resident ``InferenceSession``:
  each sweep classifies a mixed batch, every slot-table lane carrying a
  model id that selects its tenant's literal and weight slices.  Off-block
  cells hold 0 A and each lane's fired bits are gated to its own clause
  columns, so cross-tenant leakage is exactly zero and every request's
  bill is tenant-pure.
* **Per-tenant SLO classes.**  ``priority`` orders admission into free
  lanes (lower first); ``target_occupancy`` / ``max_wait_s`` set the
  tenant's firing policy (a sweep fires when any admitted lane's class is
  satisfied); ``queue_capacity`` bounds its private queue (``Backpressure``
  past ``queue_capacity`` + free lanes, per tenant).
* **Standby warm pool keyed by traffic.**  ``max_resident`` caps the
  tenants on the shared grid.  The rest are served by small dedicated
  sessions from a bounded warm pool (``standby_pool``), evicted by traffic
  EWMA; ``rebalance()`` re-picks the resident set from the same EWMA and
  rebuilds the co-resident session, which needs an idle slot table.
* **Tenant-threaded observability.**  ``RequestRecord`` carries the
  tenant id, so ``stats()`` aggregates per tenant and per SLO class; with
  a ``Tracer`` attached, each tenant of a multi-tenant zoo gets its own
  process track (``tracing.PID_TENANT_BASE + index``).

``IMPACTEngine`` is the single-tenant case: a one-tenant zoo with no plan,
whose lone model owns the grid.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..impact.runtime import InferenceSession, RuntimeSpec, build_coresident
from .clock import replay_clock
from .engine import Backpressure, BatchingQueue, Request, SlotTable, \
    latency_percentiles
from .impact_engine import BatchStats, RequestRecord, aggregate_reports
from ..tracing import PID_REQUESTS, PID_TENANT_BASE, Tracer


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
    index: int                  # stable registration index (trace pid)
    n_literals: int
    queue: BatchingQueue
    system: Any = None          # member IMPACTSystem (standby / rebalance)
    model_id: int = -1          # index into the co-resident plan; -1 standby
    lit_lo: int = 0             # literal-row offset in the shared buffer
    submitted: int = 0
    shed: int = 0
    completed: int = 0
    traffic: float = 0.0        # arrival EWMA (eviction / rebalance key)

    @property
    def resident(self) -> bool:
        return self.model_id >= 0


@dataclasses.dataclass
class _ZooLane:
    """Slot-table payload: request + admission timestamp + owning tenant."""
    req: Request
    admitted: float
    tenant: TenantState


class ModelZoo:
    """Tenant-aware continuous-batching router over one co-resident
    session, plus a bounded warm pool of standby sessions.

    Build with ``ModelZoo.build(tenants, spec, ...)`` (packs the member
    systems block-diagonally and compiles the shared session), or construct
    from an existing session: a co-resident one with one tenant per span of
    its plan, or a single-tenant one (what ``IMPACTEngine`` does).

    ``submit(tid, literals)`` enqueues into the tenant's queue; ``step()``
    admits across tenants in (priority, FIFO) order, fires at most one
    co-resident sweep plus any due standby sweeps, and returns completed
    ``(rid, prediction)`` pairs (tenant-local class indices).
    """

    def __init__(self, session: InferenceSession,
                 tenants: Sequence[tuple[str, SLOClass]], *,
                 plan=None, clock: Callable[[], float] = time.time,
                 trace: Tracer | None = None,
                 standby_capacity: int = 8, standby_pool: int = 2):
        if session.capacity is None:
            raise ValueError(
                "ModelZoo needs a session compiled with "
                "RuntimeSpec(capacity=...) — the shared slot-table sweep "
                "shape is fixed at compile time")
        plan = plan if plan is not None else session.coresident
        if plan is None and len(tenants) != 1:
            raise ValueError(
                f"{len(tenants)} tenants need a CoResidentPlan (compile "
                f"the session with RuntimeSpec(coresident=...) or use "
                f"ModelZoo.build); only a single tenant may own the "
                f"whole grid")
        if plan is not None and len(tenants) != plan.n_tenants:
            raise ValueError(
                f"{len(tenants)} tenants do not match the co-resident "
                f"plan's {plan.n_tenants} spans")
        self.session = session
        self.plan = plan
        self.clock = clock
        self.capacity = session.capacity
        self.max_resident = len(tenants)
        self._standby_capacity = standby_capacity
        self._standby_pool = standby_pool
        # Spec template for standby sessions and rebalances: the shared
        # session's spec without its plan and shapes.
        self._base_spec = dataclasses.replace(
            session.spec, coresident=None, capacity=None, batch_sizes=())

        self.tenants: list[TenantState] = []
        self._by_tid: dict[str, TenantState] = {}
        for i, (tid, slo) in enumerate(tenants):
            span = plan.spans[i] if plan is not None else None
            self._register(
                tid, slo, model_id=i,
                lit_lo=span.lit_lo if span is not None else 0,
                n_literals=(span.lit_hi - span.lit_lo
                            if span is not None
                            else session.system.n_literals))

        self.table = SlotTable(self.capacity)
        self._lane_lits = np.ones(
            (self.capacity, session.system.n_literals), np.int8)
        self._lane_mid = np.zeros((self.capacity,), np.int32)
        self.batch_stats: list[BatchStats] = []
        self.reports: list = []
        self.request_records: list[RequestRecord] = []
        self._next_rid = 0
        self._warm: set[int] = {b for (_, b)
                                in session.compiled_shapes("infer_step")}
        self._standby_sessions: dict[str, InferenceSession] = {}
        self._standby_warm: set[tuple[str, int]] = set()
        self.resident_sweeps = 0
        self.standby_sweeps = 0
        self.trace: Tracer | None = None
        self.attach_trace(trace)

    # -- construction --------------------------------------------------------
    @classmethod
    def build(cls, tenants: Sequence[tuple[str, Any, SLOClass]],
              spec: RuntimeSpec | None = None, *,
              capacity: int | None = None, max_resident: int | None = None,
              standby_capacity: int = 8, standby_pool: int = 2,
              clock: Callable[[], float] = time.time,
              trace: Tracer | None = None) -> "ModelZoo":
        """Build a zoo from ``(tid, IMPACTSystem, SLOClass)`` triples.

        The first ``max_resident`` tenants (all, when None) co-reside:
        their systems are packed block-diagonally and compiled into one
        shared session from ``spec`` (default ``RuntimeSpec()``: the
        ``"cuda"`` backend on the card, staged metering); the rest
        register as standby tenants served from the warm pool.
        ``capacity`` overrides ``spec.capacity`` (one of the two must set
        the slot-table shape).
        """
        tenants = list(tenants)
        if not tenants:
            raise ValueError("ModelZoo.build needs at least one tenant")
        spec = RuntimeSpec() if spec is None else spec
        cap = capacity if capacity is not None else spec.capacity
        if cap is None:
            raise ValueError("ModelZoo.build needs a slot-table shape: "
                             "pass capacity= or a spec with capacity set")
        n_res = (len(tenants) if max_resident is None
                 else max(1, min(max_resident, len(tenants))))
        residents, standby = tenants[:n_res], tenants[n_res:]
        combined, plan = build_coresident([s for _, s, _ in residents])
        session = combined.compile(dataclasses.replace(
            spec, coresident=plan, capacity=cap, batch_sizes=()))
        zoo = cls(session, [(tid, slo) for tid, _, slo in residents],
                  plan=plan, clock=clock, trace=trace,
                  standby_capacity=standby_capacity,
                  standby_pool=standby_pool)
        zoo.max_resident = n_res
        for (_, system, _), t in zip(residents, zoo.tenants):
            t.system = system
        for tid, system, slo in standby:
            zoo.add_standby(tid, system, slo)
        return zoo

    def _register(self, tid: str, slo: SLOClass, *, model_id: int,
                  lit_lo: int, n_literals: int,
                  system=None) -> TenantState:
        if tid in self._by_tid:
            raise ValueError(f"duplicate tenant id {tid!r}")
        resident = model_id >= 0
        t = TenantState(
            tid=tid, slo=slo, index=len(self.tenants),
            n_literals=n_literals, system=system, model_id=model_id,
            lit_lo=lit_lo,
            queue=BatchingQueue(
                max_batch=(self.capacity if resident
                           else self._standby_capacity),
                max_wait_s=slo.max_wait_s, clock=self.clock))
        self.tenants.append(t)
        self._by_tid[tid] = t
        return t

    def add_standby(self, tid: str, system, slo: SLOClass) -> TenantState:
        """Register a standby tenant: served from the bounded warm pool of
        dedicated sessions until ``rebalance()`` promotes it."""
        t = self._register(tid, slo, model_id=-1, lit_lo=0,
                           n_literals=system.n_literals, system=system)
        self._name_tenant_track(t)
        return t

    def _set_clock(self, clock: Callable[[], float]) -> None:
        """Read ``clock`` from now on: the zoo, every tenant's queue and
        the tracer."""
        self.clock = clock
        for t in self.tenants:
            t.queue.clock = clock
        if self.trace is not None:
            self.trace.clock = clock

    def attach_trace(self, trace: Tracer | None) -> None:
        """Attach (or replace) the Chrome-tracing emitter, re-clocked onto
        the zoo's clock; in a multi-tenant zoo each tenant claims its own
        process track."""
        if trace is not None:
            trace.clock = self.clock
            for t in self.tenants:
                self._name_tenant_track(t, trace)
        self.trace = trace

    def _name_tenant_track(self, t: TenantState,
                           trace: Tracer | None = None) -> None:
        trace = trace if trace is not None else self.trace
        if trace is not None and len(self.tenants) > 1:
            trace.name_process(PID_TENANT_BASE + t.index,
                               f"tenant {t.tid}")

    def _pid_for(self, t: TenantState) -> int:
        # A one-tenant zoo keeps the engine's "requests" track; a
        # multi-tenant zoo gives each tenant its own process track.
        if len(self.tenants) == 1:
            return PID_REQUESTS
        return PID_TENANT_BASE + t.index

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
        """Enqueue one (K_t,) literal vector for tenant ``tid``; returns the
        zoo-wide request id.  Raises ``ValueError`` on a mis-shaped request
        and ``Backpressure`` per the tenant's shed policy (pending >=
        ``slo.queue_capacity`` + the lanes its next sweep offers)."""
        t = self.tenant(tid)
        lits = np.asarray(literals)
        if lits.shape != (t.n_literals,):
            raise ValueError(
                f"literals shape {lits.shape} does not match tenant "
                f"{tid!r}'s compiled request shape ({t.n_literals},)")
        cap = t.slo.queue_capacity
        if cap is not None:
            # A resident tenant absorbs free lanes + queue_capacity before
            # its next sweep; a standby tenant's next sweep is one standby
            # batch.
            free = (self.table.free if t.resident
                    else self._standby_capacity)
            if len(t.queue.pending) >= cap + free:
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
        """Prepare the shared sweep shape (usually already done at session
        build)."""
        self.session.warm(self.capacity)
        self._warm.add(self.capacity)

    # -- scheduling ----------------------------------------------------------
    def _admission_order(self) -> list[TenantState]:
        return sorted((t for t in self.tenants if t.resident),
                      key=lambda t: (t.slo.priority, t.index))

    def _should_fire(self, now: float, occ: int) -> bool:
        # A sweep fires when any admitted lane's SLO class is satisfied:
        # its occupancy target is met (a full table always fires) or it
        # has waited its class's max_wait_s since admission.
        for _, lane in self.table.occupied():
            slo = lane.tenant.slo
            if occ >= self.capacity * slo.target_occupancy:
                return True
            if (now - lane.admitted) >= slo.max_wait_s:
                return True
        return False

    def step(self, *, force: bool = False) -> list[tuple[int, int]]:
        """One scheduler iteration across every tenant: admit into the
        shared table by (priority, FIFO), fire at most one co-resident
        sweep, then any due standby sweeps.  Returns completed ``(rid,
        tenant-local prediction)`` pairs; ``force`` fires below the SLO
        thresholds (tail drain)."""
        out = self._step_resident(force)
        out += self._step_standby(force)
        return out

    def _step_resident(self, force: bool) -> list[tuple[int, int]]:
        now = self.clock()
        admitted = []
        for t in self._admission_order():
            free = self.table.free
            if free == 0:
                break
            for req in t.queue.take_n(free):
                s = self.table.admit(_ZooLane(req, now, t))
                # Only the tenant's own literal rows are driven; foreign
                # slices stay 1 (floating rows, 0 A).
                self._lane_lits[s, t.lit_lo:t.lit_lo + t.n_literals] = \
                    req.tokens
                self._lane_mid[s] = t.model_id
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

    def _step_standby(self, force: bool) -> list[tuple[int, int]]:
        out: list[tuple[int, int]] = []
        for t in sorted((t for t in self.tenants if not t.resident),
                        key=lambda t: (t.slo.priority, t.index)):
            q = t.queue
            if not q.pending or not (force or q.ready()):
                continue
            sess = self._standby_session(t)
            batch = q.take_n(self._standby_capacity)
            now = self.clock()
            lanes = [(i, _ZooLane(r, now, t)) for i, r in enumerate(batch)]
            lits = np.ones((self._standby_capacity, t.n_literals), np.int8)
            valid = np.zeros((self._standby_capacity,), bool)
            for i, r in enumerate(batch):
                lits[i] = r.tokens
                valid[i] = True
            key = (t.tid, self._standby_capacity)
            cold = key not in self._standby_warm
            self._standby_warm.add(key)
            out += self._run_sweep(sess, lits, valid,
                                   self._standby_capacity, lanes,
                                   model_ids=None, cold=cold, standby=True)
        return out

    def _standby_session(self, t: TenantState) -> InferenceSession:
        """The tenant's warm-pool session, compiled on demand; a full pool
        first evicts the session of the tenant with the least traffic."""
        sess = self._standby_sessions.get(t.tid)
        if sess is None:
            if len(self._standby_sessions) >= self._standby_pool:
                victim = min(self._standby_sessions,
                             key=lambda tid: self._by_tid[tid].traffic)
                del self._standby_sessions[victim]
                self._standby_warm = {
                    k for k in self._standby_warm if k[0] != victim}
            sess = t.system.compile(dataclasses.replace(
                self._base_spec, capacity=self._standby_capacity))
            self._standby_sessions[t.tid] = sess
        return sess

    # -- execution -----------------------------------------------------------
    def execute_batch(self, lits: np.ndarray, valid: np.ndarray, shape: int,
                      lanes: list[tuple[int, _ZooLane]],
                      ) -> list[tuple[int, int]]:
        """Fire one sweep of the shared session over ``shape`` lanes (also
        the flush-mode entry of the engine)."""
        cold = shape not in self._warm
        self._warm.add(shape)
        mids = (self._lane_mid if (self.plan is not None
                                   and shape == self.capacity) else None)
        return self._run_sweep(self.session, lits, valid, shape, lanes,
                               model_ids=mids, cold=cold, standby=False)

    def _run_sweep(self, session: InferenceSession, lits: np.ndarray,
                   valid: np.ndarray, shape: int,
                   lanes: list[tuple[int, _ZooLane]], *,
                   model_ids: np.ndarray | None, cold: bool,
                   standby: bool) -> list[tuple[int, int]]:
        """One crossbar sweep + all per-step accounting (ledgers, energy
        billing, tenant-threaded trace spans)."""
        occupancy = len(lanes) / shape
        t0 = self.clock()
        if self.trace is not None:
            args = dict(shape=shape, n_valid=len(lanes),
                        occupancy=occupancy, cold=cold,
                        lanes=[i for i, _ in lanes])
            if standby:
                args["standby_tenant"] = lanes[0][1].tenant.tid
            self.trace.begin("sweep", ts=t0, args=args)
        if model_ids is not None:
            res = session.infer_step(torch.from_numpy(lits), valid,
                                     model_ids=torch.from_numpy(model_ids))
        else:
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
        if standby:
            self.standby_sweeps += 1
        else:
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
                    shape=shape, pid=self._pid_for(lane.tenant),
                    args=dict(e_read_j=r.e_read_j, pred=r.pred,
                              tenant=r.tenant))
        return [(r.rid, r.pred) for r in recs]

    # -- eviction / rebalance ------------------------------------------------
    def rebalance(self, decay: float = 0.5) -> bool:
        """Re-pick the resident set by traffic EWMA and rebuild the
        co-resident session when it changes (returns True).  Promotion
        re-programs the shared fabric, so the slot table must be idle;
        traffic counters decay by ``decay`` each call, which makes the
        EWMA window the rebalance cadence."""
        if any(t.system is None for t in self.tenants):
            # A zoo constructed from a session (the engine's) has no
            # member systems to re-pack.
            for t in self.tenants:
                t.traffic *= decay
            return False
        ranked = sorted(self.tenants,
                        key=lambda t: (-t.traffic, t.index))
        want = sorted(ranked[:self.max_resident], key=lambda t: t.index)
        have = [t for t in self.tenants if t.resident]
        if [t.tid for t in want] == [t.tid for t in have]:
            for t in self.tenants:
                t.traffic *= decay
            return False
        # Validate before mutating: a busy-table raise leaves the traffic
        # EWMAs as they were, so a retry ranks on the same counters.
        if self.table.occupancy:
            raise RuntimeError(
                "rebalance() re-programs the shared crossbar and needs "
                "an idle slot table — drain in-flight lanes first "
                "(step(force=True))")
        for t in self.tenants:
            t.traffic *= decay
        combined, plan = build_coresident([t.system for t in want])
        self.session = combined.compile(dataclasses.replace(
            self._base_spec, coresident=plan, capacity=self.capacity))
        self.plan = plan
        for t in self.tenants:
            t.model_id = -1
            t.queue.max_batch = self._standby_capacity
        for mid, t in enumerate(want):
            span = plan.spans[mid]
            t.model_id = mid
            t.lit_lo = span.lit_lo
            t.queue.max_batch = self.capacity
            # A promoted tenant rides the shared sweep now; its dedicated
            # session leaves the warm pool.
            self._standby_sessions.pop(t.tid, None)
            self._standby_warm = {
                k for k in self._standby_warm if k[0] != t.tid}
        self.table = SlotTable(self.capacity)
        self._lane_lits = np.ones(
            (self.capacity, combined.n_literals), np.int8)
        self._lane_mid = np.zeros((self.capacity,), np.int32)
        self._warm = {b for (_, b)
                      in self.session.compiled_shapes("infer_step")}
        return True

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
        """Lifetime aggregates plus per-tenant and per-SLO-class breakdowns
        (latency percentiles, energy bills, shed counts) and the resident /
        standby sweep counts."""
        bs = self.batch_stats
        warm = [s for s in bs if not s.cold] or bs
        w_total = sum(s.n_valid for s in warm)
        w_wall = sum(s.latency_s for s in warm)
        out = dict(
            tenants=len(self.tenants),
            resident=[t.tid for t in self.tenants if t.resident],
            standby=[t.tid for t in self.tenants if not t.resident],
            batches=len(bs), samples=sum(s.n_valid for s in bs),
            wall_s=sum(s.latency_s for s in bs),
            cold_batches=sum(s.cold for s in bs),
            samples_per_s=w_total / max(w_wall, 1e-9),
            mean_occupancy=(sum(s.occupancy for s in bs) / len(bs)
                            if bs else 0.0),
            sweeps=dict(resident=self.resident_sweeps,
                        standby=self.standby_sweeps),
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
            d = dict(slo=t.slo.name, resident=t.resident,
                     submitted=t.submitted, shed=t.shed,
                     completed=len(t_recs),
                     e_read_j=float(sum(r.e_read_j for r in t_recs)))
            if t_recs:
                d["latency"] = latency_percentiles(
                    [r.latency_s for r in t_recs])
            by_tenant[t.tid] = d
        out["per_tenant"] = by_tenant
        by_slo: dict[str, list[float]] = {}
        slo_meta: dict[str, SLOClass] = {}
        for t in self.tenants:
            slo_meta[t.slo.name] = t.slo
            by_slo.setdefault(t.slo.name, []).extend(
                r.latency_s for r in recs if r.tenant == t.tid)
        out["per_slo"] = {
            name: dict(priority=slo_meta[name].priority,
                       **latency_percentiles(lat))
            for name, lat in by_slo.items() if lat}
        return out


def replay_zoo_trace(zoo: ModelZoo, requests: Sequence[tuple[str, Any]],
                     arrivals: np.ndarray, *,
                     trace_path: str | None = None) -> dict:
    """Replay a mixed-tenant arrival trace through the zoo in wall-clock
    time (the multi-tenant twin of ``impact_engine.replay_trace``):
    ``requests[i]`` is ``(tenant_id, literal_row)``, submitted once
    ``arrivals[i]`` seconds have elapsed.  Returns tail-latency
    percentiles, throughput and the zoo's per-tenant / per-SLO stats;
    ``trace_path`` writes the Chrome-tracing timeline (one process track
    per tenant).  On a mesh of more than one rank every rank replays,
    reading rank 0's clock, as ``impact_engine.replay_trace`` does."""
    n = len(arrivals)
    if len(requests) < n:
        raise ValueError(
            f"replay_zoo_trace needs one request per arrival: got "
            f"{len(requests)} requests for {n} arrivals")
    with replay_clock(zoo, zoo.session.mesh, "replay_zoo_trace"):
        return _replay_zoo(zoo, requests, arrivals, trace_path)


def _replay_zoo(zoo: ModelZoo, requests, arrivals: np.ndarray,
                trace_path: str | None) -> dict:
    n = len(arrivals)
    tracer = zoo.trace
    if trace_path is not None and tracer is None:
        tracer = Tracer(clock=zoo.clock)
        zoo.attach_trace(tracer)
    q0 = len(zoo.request_records)
    shed = 0
    i = 0
    ndone = 0
    t0 = zoo.clock()
    while ndone < n - shed:
        now = zoo.clock() - t0
        while i < n and arrivals[i] <= now:
            tid, row = requests[i]
            if zoo.try_submit(tid, row) is None:
                shed += 1
                if tracer is not None:
                    tracer.instant("shed", args=dict(offered_index=i,
                                                     tenant=tid))
            i += 1
        out = zoo.step(force=i >= n)
        ndone += len(out)
        if not out:
            idle = zoo.pending == 0 and zoo.table.occupancy == 0
            gap = (arrivals[i] - (zoo.clock() - t0)
                   if (idle and i < n) else 0.0)
            before = zoo.clock()
            time.sleep(min(max(gap, 2e-4), 1e-3))
            if zoo.clock() == before:
                raise RuntimeError(
                    "replay_zoo_trace requires a wall clock: the zoo's "
                    "injected clock did not advance across a sleep — "
                    "construct the zoo with clock=time.monotonic (or "
                    "another real clock) to replay traces")
    wall = zoo.clock() - t0
    recs = zoo.request_records[q0:]
    out = dict(offered=n, shed=shed, completed=len(recs), wall_s=wall,
               samples_per_s=len(recs) / max(wall, 1e-9))
    out.update(latency_percentiles([r.latency_s for r in recs]))
    out["zoo"] = zoo.stats()
    if trace_path is not None:
        tracer.write(trace_path)
        out["trace_path"] = str(trace_path)
    return out
