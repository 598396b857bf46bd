"""NodeResourceTopology CRD model (gocrane/api topology/v1alpha1).

Python equivalent of the external CRD types the reference consumes
(ref: go.mod gocrane/api v0.7.1; usage at
pkg/plugins/noderesourcetopology/filter.go:69, helper.go:22-29,53,77,93):
a per-node CR describing NUMA zones with allocatable resources, plus the
kubelet manager policies, plus pod-annotation keys controlling awareness
and recording placement results. JSON field names follow the CRD wire
format so result annotations round-trip.

Copy of ``crane_scheduler_tpu/topology/types.py``.
"""

from __future__ import annotations

import functools
import json
from dataclasses import dataclass, field
from typing import Mapping, Protocol

# Pod/CR constants (gocrane/api topology/v1alpha1 values; usage sites in
# SURVEY §2.2).
ANNOTATION_POD_TOPOLOGY_AWARENESS = "topology.crane.io/topology-awareness"
ANNOTATION_POD_CPU_POLICY = "topology.crane.io/cpu-policy"
ANNOTATION_POD_TOPOLOGY_RESULT = "topology.crane.io/topology-result"

CPU_POLICY_NONE = "none"
CPU_POLICY_EXCLUSIVE = "exclusive"
CPU_POLICY_NUMA = "numa"
CPU_POLICY_IMMOVABLE = "immovable"
SUPPORTED_CPU_POLICIES = frozenset(
    {CPU_POLICY_NONE, CPU_POLICY_EXCLUSIVE, CPU_POLICY_NUMA, CPU_POLICY_IMMOVABLE}
)

CPU_MANAGER_POLICY_STATIC = "Static"
CPU_MANAGER_POLICY_NONE = "None"
TOPOLOGY_MANAGER_POLICY_SINGLE_NUMA_POD = "SingleNUMANodePodLevel"
TOPOLOGY_MANAGER_POLICY_NONE = "None"

ZONE_TYPE_NODE = "Node"  # a NUMA node zone


@dataclass(frozen=True)
class ZoneResourceInfo:
    """ref: gocrane/api ResourceInfo{Allocatable, Capacity}."""

    allocatable: Mapping[str, object] = field(default_factory=dict)
    capacity: Mapping[str, object] = field(default_factory=dict)


@dataclass(frozen=True)
class Zone:
    name: str
    type: str = ZONE_TYPE_NODE
    resources: ZoneResourceInfo | None = None

    def to_wire(self) -> dict:
        out: dict = {"name": self.name, "type": self.type}
        if self.resources is not None:
            res: dict = {}
            if self.resources.capacity:
                res["capacity"] = dict(self.resources.capacity)
            if self.resources.allocatable:
                res["allocatable"] = dict(self.resources.allocatable)
            out["resources"] = res
        return out

    @staticmethod
    def from_wire(doc: Mapping) -> "Zone":
        res = doc.get("resources") or {}
        resources = None
        if res:
            resources = ZoneResourceInfo(
                allocatable=res.get("allocatable") or {},
                capacity=res.get("capacity") or {},
            )
        return Zone(
            name=str(doc.get("name", "")),
            type=str(doc.get("type", ZONE_TYPE_NODE)),
            resources=resources,
        )


def zones_to_json(zones: list[Zone]) -> str:
    """Serialize a ZoneList for the pod result annotation
    (ref: binder.go:36-44)."""
    return json.dumps([z.to_wire() for z in zones], separators=(",", ":"))


def zones_from_json(raw: str) -> list[Zone] | None:
    """Parse a result annotation; None on any decode error
    (ref: helper.go:76-88).

    Memoized per raw string: node-wrapper rebuilds re-parse every bound
    pod's result annotation each cycle. Each call returns fresh Zone
    objects with fresh resource dicts — Zone itself is frozen but its
    resource Mappings are plain dicts, and handing out cache-shared
    dicts would let one caller's mutation poison every later parse of
    the same annotation.
    """
    zones = _zones_from_json_cached(raw) if isinstance(raw, str) else None
    if zones is None:
        return None
    return [
        Zone(
            name=z.name,
            type=z.type,
            resources=None
            if z.resources is None
            else ZoneResourceInfo(
                allocatable=dict(z.resources.allocatable),
                capacity=dict(z.resources.capacity),
            ),
        )
        for z in zones
    ]


@functools.lru_cache(maxsize=65536)
def _zones_from_json_cached(raw: str) -> tuple[Zone, ...] | None:
    try:
        docs = json.loads(raw)
    except (TypeError, ValueError):
        return None
    if not isinstance(docs, list):
        return None
    try:
        return tuple(Zone.from_wire(d) for d in docs)
    except (AttributeError, TypeError):
        return None


@dataclass(frozen=True)
class CraneManagerPolicy:
    cpu_manager_policy: str = CPU_MANAGER_POLICY_NONE
    topology_manager_policy: str = TOPOLOGY_MANAGER_POLICY_NONE


@dataclass(frozen=True)
class NodeResourceTopology:
    """The per-node CR (name matches the node name)."""

    name: str
    crane_manager_policy: CraneManagerPolicy = field(default_factory=CraneManagerPolicy)
    zones: tuple[Zone, ...] = ()


class NRTLister(Protocol):
    def get(self, name: str) -> NodeResourceTopology:
        """Raise KeyError when absent."""
        ...


class InMemoryNRTLister:
    """Dict-backed lister (the fake-clientset equivalent used in tests and
    the simulator; ref: filter_test.go:366-367)."""

    def __init__(self):
        self._items: dict[str, NodeResourceTopology] = {}
        self._version = 0

    @property
    def version(self) -> int:
        """Monotonic CR mutation counter (informer resourceVersion
        stand-in); lets readers cache views derived from the CR set."""
        return self._version

    def upsert(self, nrt: NodeResourceTopology) -> None:
        self._items[nrt.name] = nrt
        self._version += 1

    def delete(self, name: str) -> None:
        self._items.pop(name, None)
        self._version += 1

    def names(self) -> list[str]:
        return list(self._items)

    def get(self, name: str) -> NodeResourceTopology:
        return self._items[name]
