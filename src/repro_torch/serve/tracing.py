"""The serving engines' tracing, re-exported from ``repro_torch.tracing``
(the port's one tracing module), where the session and billing code can
import it too."""
from ..tracing import (PID_ENGINE, PID_REQUESTS, PID_TENANT_BASE,  # noqa: F401
                       REQUEST_PHASES, Tracer, validate_events)
