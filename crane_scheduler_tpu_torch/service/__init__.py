"""The scoring sidecar: ``ScoringService`` behind an HTTP front end.

Counterpart of ``crane_scheduler_tpu/service/__init__.py``. The
reference's leader election (``LeaderElector``, ``kube_leader``) waits
for the kube mirror (``ROADMAP.md`` Queue 1 item 8), its replicated tier
(``ServingReplica``, ``ReplicaRouter``) for item 6b.
"""

from . import deadline
from .scoring import ScoringService
from .http import ScoringHTTPServer, HealthServer
from .overload import (
    AdmissionController,
    BrownoutController,
    GradientLimiter,
    TenantQueues,
    TokenBucket,
)

__all__ = [
    "AdmissionController",
    "BrownoutController",
    "GradientLimiter",
    "HealthServer",
    "ScoringHTTPServer",
    "ScoringService",
    "TenantQueues",
    "TokenBucket",
    "deadline",
]
