"""Shared fault-domain resilience layer.

Counterpart of ``crane_scheduler_tpu/resilience/__init__.py``, with the
four pieces the scoring sidecar and the annotator use:

- ``CircuitBreaker`` — closed/open/half-open over a sliding failure
  window, one instance per fault target (``device-dispatch`` for the
  sidecar's scorer);
- ``HealthRegistry`` — aggregates component states
  (healthy/degraded/failed, with reasons), served on ``/healthz`` and
  exported as ``crane_health_state{component}`` gauges;
- ``DegradedModeController`` — cluster-wide staleness tracker over the
  ``value,timestamp`` annotations with enter/exit hysteresis; while
  active the sidecar serves spread-only scores.

- ``RetryPolicy`` — full-jitter exponential backoff with per-call
  deadline budgets and ``Retry-After`` awareness (the Prometheus
  client's retries).

The reference's ``chaos``, ``loadgen`` and ``recovery`` modules (the
fault injectors, the open-loop storm generator and the crash-safe intent
journal) belong to the host planes around the kube mirror and are not
ported yet (``ROADMAP.md`` Queue 1 item 8).
"""

from .breaker import BreakerOpenError, BreakerState, CircuitBreaker
from .degraded import DegradedModeController
from .health import HealthRegistry, HealthState
from .retry import RetryBudgetExceeded, RetryPolicy

__all__ = [
    "BreakerOpenError",
    "BreakerState",
    "CircuitBreaker",
    "DegradedModeController",
    "HealthRegistry",
    "HealthState",
    "RetryBudgetExceeded",
    "RetryPolicy",
]
