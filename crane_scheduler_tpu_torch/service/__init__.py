"""The scoring sidecar: ``ScoringService`` behind an HTTP front end.

Counterpart of ``crane_scheduler_tpu/service/__init__.py``, with the
replicated tier (``ServingReplica``, ``ReplicaRouter``), the file-lock
``LeaderElector`` and the apiserver lease (``kube_leader``).
"""

from . import deadline
from .scoring import ScoringService
from .http import ScoringHTTPServer, HealthServer
from .leader import LeaderElector
from .overload import (
    AdmissionController,
    BrownoutController,
    GradientLimiter,
    TenantQueues,
    TokenBucket,
)
from .replica import ServingReplica
from .router import ReplicaRouter

__all__ = [
    "AdmissionController",
    "BrownoutController",
    "GradientLimiter",
    "HealthServer",
    "LeaderElector",
    "ReplicaRouter",
    "ScoringHTTPServer",
    "ScoringService",
    "ServingReplica",
    "TenantQueues",
    "TokenBucket",
    "deadline",
]
