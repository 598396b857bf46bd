"""Vectorized resource-fit layer.

Counterpart of ``crane_scheduler_tpu/fit/__init__.py``: columnar
allocatable/requested accounting maintained incrementally off the
``ClusterState`` mirror, exposed as ``ResourceFitPlugin``, a framework
Filter predicate with stock NodeResourcesFit semantics, and as
``FitTracker.free_matrix``, the drip column cache's free-capacity rows.
"""

from .tracker import (
    UNBOUNDED,
    FitTracker,
    pod_fit_request,
    request_vec,
    row_fail_reason,
)
from .plugin import PLUGIN_NAME, ResourceFitPlugin

__all__ = [
    "UNBOUNDED",
    "FitTracker",
    "pod_fit_request",
    "request_vec",
    "row_fail_reason",
    "ResourceFitPlugin",
    "PLUGIN_NAME",
]
