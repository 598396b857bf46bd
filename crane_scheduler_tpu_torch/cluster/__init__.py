from .state import ClusterState, Event, Node, Pod

__all__ = ["ClusterState", "Event", "Node", "Pod"]
