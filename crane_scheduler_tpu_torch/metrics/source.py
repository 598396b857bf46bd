"""Pluggable metrics source interface.

Copy of ``crane_scheduler_tpu/metrics/source.py``.

Mirrors the reference's ``PromClient`` interface
(ref: pkg/controller/prometheus/prometheus.go:21-28): queries return the
metric value as a *string* (the wire value that lands verbatim in the
annotation, 5-decimal formatted), or None/raise on failure. The annotator
only depends on this protocol; Prometheus is one implementation, the fake
is another, and a bulk-capable source can serve whole columns at once.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable


class MetricsQueryError(Exception):
    pass


class MetricsTransportError(MetricsQueryError):
    """The query never produced a usable answer: connection refused,
    timeout, 429/5xx, malformed body. Distinct from "no data" (an empty
    vector) and from protocol errors on a healthy server — a transport
    error means the *source* is unhealthy, so it must propagate (and
    count against the circuit breaker) instead of masquerading as a
    missing metric and triggering fallback queries.

    ``retry_after_s`` carries the server's Retry-After hint (0 when
    absent) for the retry policy's backoff floor.
    """

    def __init__(self, message: str, retry_after_s: float = 0.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


@runtime_checkable
class MetricsSource(Protocol):
    def query_by_node_ip(self, metric_name: str, ip: str) -> str:
        """Value string for (metric, node-ip); raises MetricsQueryError."""
        ...

    def query_by_node_name(self, metric_name: str, name: str) -> str:
        """Value string for (metric, node-name); raises MetricsQueryError."""
        ...
