"""Continuous-batching IMPACT inference front: crossbar serving under
request traffic (the PyTorch port of ``repro.serve.impact_engine``).

* **Slot table, not flush-and-drain.**  A fixed-capacity ``SlotTable``
  backs a persistent (capacity, K) literal buffer.  Free lanes hold
  all-1 literals (every crossbar row floats, so they draw no current).
  Each step admits queued requests into free lanes, runs ONE sweep of
  the session's ``infer_step`` at the fixed capacity, then releases every
  lane; a late arrival waits at most one sweep.
* **Admission policy.**  A step fires when occupancy reaches
  ``target_occupancy``, when the oldest admitted request has waited
  ``max_wait_s``, or when the table is full.
* **Backpressure.**  ``queue_capacity`` bounds the admission queue;
  ``submit`` raises ``Backpressure`` past it (``try_submit`` returns
  ``None``).
* **Per-request metering.**  Every request gets a ``RequestRecord`` with
  end-to-end latency and its own read-energy bill from the per-lane
  meters; the bills sum to the batch meter in float64.
* **Flush mode kept for A/B.**  ``mode="flush"`` is the accumulate /
  pad-to-bucket scheduler.

The engine serves through a compiled ``InferenceSession``: backend,
metering mode, device, mesh topology and the slot-table shape are
properties of its ``RuntimeSpec``.  It is the single-tenant special case
of ``serve.zoo.ModelZoo``.

A sharded session (one with a shard plan on a mesh) is SPMD: every rank
issues the same sequence of sweeps with the same inputs.  So on a mesh
every rank runs its own engine over the same requests, and every rank's
clock must read the same, which makes every admission decision the
same; each rank then holds the full predictions and bills.  ``run``
takes such a clock from the caller (``clock=``); ``replay_trace`` on a
mesh of more than one rank reads rank 0's wall clock on every rank
(``serve.clock.MeshClock``), so each rank calls it with the same
arguments.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Callable, Sequence

import numpy as np

from ..impact.energy import EnergyReport
from ..impact.pipeline import IMPACTSystem
from ..impact.runtime import InferenceSession, RuntimeSpec
from .clock import replay_clock
from .engine import Backpressure, BatchingQueue, Request, SlotTable
from .engine import latency_percentiles
from ..tracing import Tracer

DEFAULT_BUCKETS = (8, 32, 128, 512)


def aggregate_reports(reports: Sequence[EnergyReport]) -> EnergyReport:
    """Sum energy/op/datapoint accounting over per-batch reports; latency
    is the serial crossbar time of the whole run.  ``area_mm2`` is not
    carried over (``tops_per_mm2`` of a summed-latency aggregate would
    describe the number of sweeps, not the hardware)."""
    if not reports:
        raise ValueError("no reports to aggregate")
    return EnergyReport(
        read_energy_j=sum(r.read_energy_j for r in reports),
        clause_energy_j=sum(r.clause_energy_j for r in reports),
        class_energy_j=sum(r.class_energy_j for r in reports),
        program_energy_j=reports[0].program_energy_j,   # one-time encode
        erase_energy_j=reports[0].erase_energy_j,
        latency_s=sum(r.latency_s for r in reports),
        ops_crosspoint=sum(r.ops_crosspoint for r in reports),
        datapoints=sum(r.datapoints for r in reports),
        write_energy_j=sum(r.write_energy_j for r in reports),
    )


@dataclasses.dataclass
class RequestRecord:
    """Per-request accounting: queue wait + service latency and the read
    energy this request's datapoint drew on the crossbar."""
    rid: int
    arrived: float
    admitted: float
    completed: float
    pred: int
    e_read_j: float = 0.0
    tenant: str = "default"

    @property
    def latency_s(self) -> float:
        return self.completed - self.arrived

    @property
    def queue_s(self) -> float:
        return self.admitted - self.arrived


@dataclasses.dataclass
class BatchStats:
    bucket: int           # kernel shape: slot capacity (continuous) / bucket
    n_valid: int
    latency_s: float      # wall time of this sweep
    samples_per_s: float
    cold: bool = False    # first sweep of this shape
    occupancy: float = 0.0
    p50_s: float = 0.0    # end-to-end request-latency percentiles of the
    p95_s: float = 0.0    # requests completed by this step
    p99_s: float = 0.0


class IMPACTEngine:
    """Crossbar inference with a continuous-batching scheduler.

    ``submit`` enqueues a literal vector (raising ``Backpressure`` when
    saturated); ``step`` runs one scheduler iteration and returns
    completed ``(rid, prediction)`` pairs; ``run`` drives a burst to
    completion.  ``runtime`` is a session compiled with a capacity, or a
    bare ``IMPACTSystem``, which compiles the default spec at
    ``max_batch`` (128 when unset) on the system's own device.

    ``trace`` (a ``repro_torch.tracing.Tracer``) records the scheduler
    timeline as Chrome-tracing spans, re-clocked onto the engine's clock.
    """

    def __init__(self, runtime: "InferenceSession | IMPACTSystem", *,
                 mode: str = "continuous", max_batch: int | None = None,
                 max_wait_s: float = 0.01,
                 buckets: Sequence[int] | None = None,
                 target_occupancy: float = 0.0,
                 queue_capacity: int | None = None,
                 clock: Callable[[], float] = time.time,
                 trace: Tracer | None = None):
        if mode not in ("continuous", "flush"):
            raise ValueError(f"mode must be 'continuous' or 'flush', "
                             f"got {mode!r}")
        if mode == "continuous" and buckets is not None:
            raise ValueError(
                "buckets only apply to mode='flush' (the continuous "
                "scheduler always sweeps the fixed slot-table shape); "
                f"got buckets={tuple(buckets)!r}")
        if mode == "flush" and target_occupancy != 0.0:
            raise ValueError(
                "target_occupancy only applies to mode='continuous' "
                "(flush fires on full/stale batches); got "
                f"target_occupancy={target_occupancy!r}")
        if not 0.0 <= target_occupancy <= 1.0:
            raise ValueError(f"target_occupancy must be in [0, 1], "
                             f"got {target_occupancy}")

        if isinstance(runtime, IMPACTSystem):
            session = runtime.compile(RuntimeSpec(
                capacity=128 if max_batch is None else max_batch,
                device=str(runtime.device)))
        else:
            session = runtime
            if session.capacity is None:
                raise ValueError(
                    "IMPACTEngine needs a session compiled with "
                    "RuntimeSpec(capacity=...) — the slot-table sweep "
                    "shape is fixed at compile time")
            if max_batch is not None and max_batch != session.capacity:
                raise ValueError(
                    f"max_batch={max_batch} does not match the session's "
                    f"compiled capacity {session.capacity}")
        if session.coresident is not None:
            raise ValueError(
                "IMPACTEngine is the single-tenant front — a co-resident "
                "session routes per-lane model ids and needs the "
                "multi-tenant router (serve.zoo.ModelZoo)")
        self.session = session
        self.system = session.system
        self.mesh = session.mesh
        self.impl = session.spec.backend
        self.meter_energy = session.meters_energy
        self.mode = mode
        self.capacity = session.capacity
        max_batch = self.capacity
        self.max_wait_s = max_wait_s
        self.target_occupancy = target_occupancy
        self.queue_capacity = queue_capacity
        self.clock = clock
        if mode == "flush":
            # Buckets above max_batch are unreachable; max_batch itself is
            # always a bucket.
            buckets = DEFAULT_BUCKETS if buckets is None else buckets
            self.buckets = sorted(b for b in set(int(b) for b in buckets)
                                  | {max_batch} if b <= max_batch)
        else:
            self.buckets = [max_batch]
        from .zoo import ModelZoo, SLOClass   # deferred: zoo imports us
        slo = SLOClass(name="default", priority=0,
                       target_occupancy=target_occupancy,
                       max_wait_s=max_wait_s,
                       queue_capacity=queue_capacity)
        self._zoo = ModelZoo(session, [("default", slo)], clock=clock,
                             trace=trace)

    # -- zoo-backed state (the engine IS a one-tenant zoo) -------------------
    @property
    def queue(self) -> BatchingQueue:
        return self._zoo.tenants[0].queue

    @property
    def table(self) -> SlotTable:
        return self._zoo.table

    @property
    def batch_stats(self) -> list[BatchStats]:
        return self._zoo.batch_stats

    @property
    def reports(self) -> list[EnergyReport]:
        return self._zoo.reports

    @property
    def request_records(self) -> list[RequestRecord]:
        return self._zoo.request_records

    @property
    def trace(self) -> Tracer | None:
        return self._zoo.trace

    def _set_clock(self, clock: Callable[[], float]) -> None:
        """Read ``clock`` from now on, here and in the zoo below."""
        self.clock = clock
        self._zoo._set_clock(clock)

    @trace.setter
    def trace(self, tracer: Tracer | None) -> None:
        self._zoo.attach_trace(tracer)

    def warmup(self) -> None:
        """Prepare every sweep shape this engine can fire (the slot-table
        shape in continuous mode, every bucket in flush mode); nothing is
        executed or metered."""
        shapes = [self.capacity] if self.mode == "continuous" else self.buckets
        for b in shapes:
            self.session.warm(b)
            self._zoo._warm.add(b)

    # -- request plumbing ---------------------------------------------------
    def submit(self, literals: np.ndarray) -> int:
        """Enqueue one (K,) literal vector; returns the request id.  Raises
        ``ValueError`` on a mis-shaped request and ``Backpressure`` when
        every slot is occupied and the queue is at ``queue_capacity``."""
        return self._zoo.submit("default", literals)

    def try_submit(self, literals: np.ndarray) -> int | None:
        """``submit`` that signals backpressure as ``None``."""
        try:
            return self.submit(literals)
        except Backpressure:
            return None

    def bucket_for(self, n: int) -> int:
        """Smallest configured bucket >= n (largest bucket caps max_batch)."""
        i = bisect.bisect_left(self.buckets, n)
        return self.buckets[min(i, len(self.buckets) - 1)]

    @staticmethod
    def pad_to_bucket(batch: list[Request], bucket: int, n_literals: int,
                      ) -> tuple[np.ndarray, np.ndarray]:
        """Stack requests into (bucket, K) literals + validity mask;
        padding lanes are all-1 literals (floating rows, no current)."""
        lits = np.ones((bucket, n_literals), np.int8)
        valid = np.zeros((bucket,), bool)
        for i, r in enumerate(batch):
            lits[i] = r.tokens
            valid[i] = True
        return lits, valid

    # -- execution ----------------------------------------------------------
    def _step_flush(self, force: bool) -> list[tuple[int, int]]:
        if not (self.queue.ready() or (force and self.queue.pending)):
            return []
        from .zoo import _ZooLane
        t_take = self.clock()
        batch = self.queue.take()
        bucket = self.bucket_for(len(batch))
        lits, valid = self.pad_to_bucket(batch, bucket,
                                         self.system.n_literals)
        now = self.clock()
        tenant = self._zoo.tenants[0]
        lanes = [(i, _ZooLane(r, now, tenant)) for i, r in enumerate(batch)]
        if self.trace is not None:
            self.trace.span("admission", t_take, now, args=dict(
                lanes=list(range(len(batch))), bucket=bucket,
                occupancy=len(batch) / bucket))
        return self._zoo.execute_batch(lits, valid, bucket, lanes)

    def step(self, *, force: bool = False) -> list[tuple[int, int]]:
        """One scheduler iteration; returns completed (rid, pred) pairs.
        ``force`` fires below the admission-policy thresholds."""
        if self.mode == "flush":
            return self._step_flush(force)
        return self._zoo.step(force=force)

    def run(self, literals: np.ndarray) -> tuple[np.ndarray, dict]:
        """Serve a (B, K) request burst to completion; returns predictions
        in submission order + statistics for THIS burst only."""
        b0, r0, q0 = (len(self.batch_stats), len(self.reports),
                      len(self.request_records))
        rows = np.asarray(literals)
        rids: list[int] = []
        done: dict[int, int] = {}
        i = 0
        while len(done) < rows.shape[0]:
            while i < rows.shape[0]:        # submit until backpressure
                rid = self.try_submit(rows[i])
                if rid is None:
                    break
                rids.append(rid)
                i += 1
            done.update(self.step(force=not self.queue.ready()))
        preds = np.asarray([done[r] for r in rids])
        return preds, self.stats(since_batch=b0, since_report=r0,
                                 since_request=q0)

    def stats(self, *, since_batch: int = 0, since_report: int = 0,
              since_request: int = 0) -> dict:
        bs = self.batch_stats[since_batch:]
        total = sum(s.n_valid for s in bs)
        wall = sum(s.latency_s for s in bs)
        # Throughput from WARM batches only (a shape's first sweep may
        # pay one-time set-up); all batches when everything was cold.
        warm = [s for s in bs if not s.cold] or bs
        w_total = sum(s.n_valid for s in warm)
        w_wall = sum(s.latency_s for s in warm)
        out = dict(
            mode=self.mode,
            batches=len(bs), samples=total, wall_s=wall,
            cold_batches=sum(s.cold for s in bs),
            samples_per_s=w_total / max(w_wall, 1e-9),
            mean_batch_latency_s=w_wall / max(len(warm), 1),
            mean_occupancy=(sum(s.occupancy for s in bs) / len(bs)
                            if bs else 0.0),
            buckets_used=sorted({s.bucket for s in bs}),
        )
        recs = self.request_records[since_request:]
        if recs:
            out["latency"] = latency_percentiles(
                [r.latency_s for r in recs])
            out["queue_wait"] = latency_percentiles(
                [r.queue_s for r in recs])
        reports = self.reports[since_report:]
        if reports:
            agg = aggregate_reports(reports)
            out["energy"] = agg
            out["energy_per_datapoint_j"] = agg.energy_per_datapoint_j
        return out


# -- arrival-trace replay (mixed-traffic benchmarking) ----------------------

def poisson_arrivals(n: int, rate_rps: float, seed: int = 0) -> np.ndarray:
    """Cumulative arrival offsets (seconds) of a seeded Poisson process;
    ``rate_rps`` must be > 0 and ``n`` >= 0."""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate_rps, size=n))


def replay_trace(engine: IMPACTEngine, literals: np.ndarray,
                 arrivals: np.ndarray, *,
                 trace_path: str | None = None) -> dict:
    """Replay an arrival trace through an engine in wall-clock time:
    request ``i`` is submitted once ``arrivals[i]`` seconds have elapsed
    and the scheduler steps continuously.  The engine must be on a wall
    clock (a frozen injected clock raises instead of hanging).  Returns
    tail-latency percentiles + throughput; ``trace_path`` writes the
    Chrome-tracing timeline.

    On a mesh of more than one rank every rank replays the same trace
    through its own engine, and every reading of the clock is rank 0's
    (``serve.clock.replay_clock``): the ranks take the same decisions and
    return the same result.  An injected clock there raises."""
    n = len(arrivals)
    if literals.shape[0] < n:
        raise ValueError(
            f"replay_trace needs one literal row per arrival: got "
            f"{literals.shape[0]} rows for {n} arrivals")
    with replay_clock(engine, engine.mesh, "replay_trace"):
        return _replay(engine, literals, arrivals, trace_path)


def _replay(engine: IMPACTEngine, literals: np.ndarray, arrivals: np.ndarray,
            trace_path: str | None) -> dict:
    n = len(arrivals)
    tracer = engine.trace
    if trace_path is not None and tracer is None:
        tracer = Tracer(clock=engine.clock)
        engine.trace = tracer
    q0 = len(engine.request_records)
    shed = 0
    i = 0
    ndone = 0
    t0 = engine.clock()
    while ndone < n - shed:
        now = engine.clock() - t0
        while i < n and arrivals[i] <= now:
            if engine.try_submit(literals[i]) is None:
                shed += 1              # load shed at the backpressure edge
                if tracer is not None:
                    tracer.instant("shed", args=dict(offered_index=i))
            i += 1
        out = engine.step(force=i >= n)
        ndone += len(out)
        if not out:
            # Sub-ms tick while the scheduler defers; sleep toward the next
            # arrival when fully idle.
            idle = (not engine.queue.pending
                    and engine.table.occupancy == 0)
            gap = (arrivals[i] - (engine.clock() - t0)
                   if (idle and i < n) else 0.0)
            before = engine.clock()
            time.sleep(min(max(gap, 2e-4), 1e-3))
            if engine.clock() == before:
                raise RuntimeError(
                    "replay_trace requires a wall clock: the engine's "
                    "injected clock did not advance across a sleep — "
                    "construct the engine with clock=time.monotonic (or "
                    "another real clock) to replay traces")
    wall = engine.clock() - t0
    recs = engine.request_records[q0:]
    out = dict(mode=engine.mode, offered=n, shed=shed,
               completed=len(recs), wall_s=wall,
               samples_per_s=len(recs) / max(wall, 1e-9))
    out.update(latency_percentiles([r.latency_s for r in recs]))
    if trace_path is not None:
        tracer.write(trace_path)
        out["trace_path"] = str(trace_path)
    return out
