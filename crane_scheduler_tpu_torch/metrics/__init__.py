"""Metrics sources for the annotator: the ``MetricsSource`` protocol, a
dict-backed fake, and the Prometheus HTTP client.

Counterpart of ``crane_scheduler_tpu/metrics/__init__.py``.
"""

from .source import MetricsQueryError, MetricsSource, MetricsTransportError
from .fake import FakeMetricsSource
from .prometheus import PrometheusClient

__all__ = [
    "FakeMetricsSource",
    "MetricsQueryError",
    "MetricsSource",
    "MetricsTransportError",
    "PrometheusClient",
]
