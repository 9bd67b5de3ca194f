"""Serving: the continuous-batching slot table and queue, the IMPACT
crossbar engine on its single-tenant zoo, and Chrome-tracing spans."""
from .engine import (Backpressure, BatchingQueue, Request, SlotTable,
                     latency_percentiles)
from .impact_engine import (BatchStats, IMPACTEngine, RequestRecord,
                            aggregate_reports, poisson_arrivals,
                            replay_trace)
from .tracing import REQUEST_PHASES, Tracer, validate_events
from .zoo import ModelZoo, SLOClass, TenantState

__all__ = ["BatchingQueue", "Request", "SlotTable", "Backpressure",
           "latency_percentiles", "IMPACTEngine", "BatchStats",
           "RequestRecord", "aggregate_reports", "poisson_arrivals",
           "replay_trace", "ModelZoo", "SLOClass", "TenantState", "Tracer",
           "validate_events", "REQUEST_PHASES"]
