from .state import (
    ClusterState,
    Container,
    Event,
    Node,
    NodeAddress,
    OwnerReference,
    Pod,
    ResourceRequirements,
)

__all__ = [
    "ClusterState",
    "Container",
    "Event",
    "Node",
    "NodeAddress",
    "OwnerReference",
    "Pod",
    "ResourceRequirements",
]
