"""Serving: the LM engine (``Engine``, ``ServeConfig``), the
continuous-batching slot table and queue, the IMPACT crossbar engine (a one-tenant zoo), the multi-tenant model zoo over
co-resident crossbars, Chrome-tracing spans, and the document
classifier (``Classifier``: an LM's pooled states read by a CoTM head on
the IMPACT session)."""
from .classify import Classified, Classifier
from .engine import (Backpressure, BatchingQueue, Engine, Request,
                     ServeConfig, SlotTable, latency_percentiles)
from .impact_engine import (BatchStats, IMPACTEngine, RequestRecord,
                            aggregate_reports, poisson_arrivals,
                            replay_trace)
from ..tracing import REQUEST_PHASES, Tracer, validate_events
from .zoo import ModelZoo, SLOClass, TenantState, replay_zoo_trace

__all__ = ["Engine", "ServeConfig", "BatchingQueue", "Request", "SlotTable", "Backpressure",
           "latency_percentiles", "IMPACTEngine", "BatchStats",
           "RequestRecord", "aggregate_reports", "poisson_arrivals",
           "replay_trace", "ModelZoo", "SLOClass", "TenantState",
           "replay_zoo_trace", "Tracer", "validate_events",
           "REQUEST_PHASES", "Classifier", "Classified"]
