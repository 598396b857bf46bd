"""NUMA topology: the ``NodeResourceTopologyMatch`` plugin, its types,
helper and assume cache, and the batched zone evaluation
(``topology.batched``).

Counterpart of ``crane_scheduler_tpu/topology/__init__.py``, with the
same exports.
"""

from .types import (
    Zone,
    ZoneResourceInfo,
    CraneManagerPolicy,
    NodeResourceTopology,
    NRTLister,
    ZONE_TYPE_NODE,
    CPU_MANAGER_POLICY_STATIC,
    TOPOLOGY_MANAGER_POLICY_SINGLE_NUMA_POD,
    ANNOTATION_POD_TOPOLOGY_AWARENESS,
    ANNOTATION_POD_CPU_POLICY,
    ANNOTATION_POD_TOPOLOGY_RESULT,
)
from .cache import PodTopologyCache
from .plugin import TopologyMatch

__all__ = [
    "Zone",
    "ZoneResourceInfo",
    "CraneManagerPolicy",
    "NodeResourceTopology",
    "NRTLister",
    "ZONE_TYPE_NODE",
    "CPU_MANAGER_POLICY_STATIC",
    "TOPOLOGY_MANAGER_POLICY_SINGLE_NUMA_POD",
    "ANNOTATION_POD_TOPOLOGY_AWARENESS",
    "ANNOTATION_POD_CPU_POLICY",
    "ANNOTATION_POD_TOPOLOGY_RESULT",
    "PodTopologyCache",
    "TopologyMatch",
]
