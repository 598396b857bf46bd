from .state import (
    ClusterState,
    Container,
    Event,
    Node,
    OwnerReference,
    Pod,
    ResourceRequirements,
)

__all__ = [
    "ClusterState",
    "Container",
    "Event",
    "Node",
    "OwnerReference",
    "Pod",
    "ResourceRequirements",
]
