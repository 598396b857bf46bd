"""Scheduler-framework core types.

A compact equivalent of the k8s scheduler framework surface the reference
plugins program against (ref: k8s.io/kubernetes/pkg/scheduler/framework):
``Status``/``Code`` verdicts, per-cycle ``CycleState``, ``NodeInfo``
snapshot entries, and the ``Resource`` accounting struct used by the NUMA
plugin (MilliCPU / Memory / EphemeralStorage / scalar resources).

Copy of ``crane_scheduler_tpu/framework/types.py``.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field
from typing import Any, Mapping

from ..cluster.state import Node, Pod
from ..utils.quantity import to_milli, to_value


class Code(enum.Enum):
    SUCCESS = 0
    ERROR = 1
    UNSCHEDULABLE = 2


@dataclass(frozen=True)
class Status:
    code: Code = Code.SUCCESS
    reason: str = ""

    @staticmethod
    def success() -> "Status":
        return Status(Code.SUCCESS, "")

    @staticmethod
    def error(reason: str) -> "Status":
        return Status(Code.ERROR, reason)

    @staticmethod
    def unschedulable(reason: str) -> "Status":
        return Status(Code.UNSCHEDULABLE, reason)

    def ok(self) -> bool:
        return self.code == Code.SUCCESS


class CycleState:
    """Per-scheduling-cycle key/value state (thread-safe like the
    framework's CycleState: Filter runs concurrently per node)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._data: dict[str, Any] = {}

    def write(self, key: str, value: Any) -> None:
        with self._lock:
            self._data[key] = value

    def read(self, key: str) -> Any:
        with self._lock:
            if key not in self._data:
                raise KeyError(key)
            return self._data[key]

    def lock(self):
        return self._lock


@dataclass
class NodeInfo:
    """Informer-snapshot entry: a node plus the pods placed on it."""

    node: Node | None
    pods: list[Pod] = field(default_factory=list)


CPU = "cpu"
MEMORY = "memory"
EPHEMERAL_STORAGE = "ephemeral-storage"
PODS = "pods"
_HUGEPAGES_PREFIX = "hugepages-"


@dataclass
class Resource:
    """ref: k8s framework.Resource — integer accounting units:
    millicores for CPU, whole units (bytes) otherwise."""

    milli_cpu: int = 0
    memory: int = 0
    ephemeral_storage: int = 0
    allowed_pod_number: int = 0
    scalar_resources: dict[str, int] = field(default_factory=dict)

    def clone(self) -> "Resource":
        return Resource(
            self.milli_cpu,
            self.memory,
            self.ephemeral_storage,
            self.allowed_pod_number,
            dict(self.scalar_resources),
        )

    def add(self, resource_list: Mapping[str, Any]) -> None:
        """Accumulate a ResourceList (name -> quantity)."""
        for name, quantity in (resource_list or {}).items():
            if name == CPU:
                self.milli_cpu += to_milli(quantity)
            elif name == MEMORY:
                self.memory += to_value(quantity)
            elif name == EPHEMERAL_STORAGE:
                self.ephemeral_storage += to_value(quantity)
            elif name == PODS:
                self.allowed_pod_number += to_value(quantity)
            else:
                self.scalar_resources[name] = self.scalar_resources.get(
                    name, 0
                ) + to_value(quantity)


def resource_from_requests(resource_list: Mapping[str, Any] | None) -> Resource:
    r = Resource()
    if resource_list:
        r.add(resource_list)
    return r


def pod_effective_request(pod: Pod) -> Resource:
    """Sum of container requests (init containers not modeled)."""
    r = Resource()
    for c in pod.containers:
        r.add(c.resources.requests)
    return r


def is_hugepage_resource(name: str) -> bool:
    return name.startswith(_HUGEPAGES_PREFIX)
