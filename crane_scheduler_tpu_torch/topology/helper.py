"""NUMA accounting core.

Python equivalent of the reference's zone math
(ref: pkg/plugins/noderesourcetopology/helper.go): guaranteed-CPU
detection, pod topology-result decoding, per-zone requested/allocatable
tracking, the NUMA-fit check, and the greedy bin-pack of a request across
zones sorted by free CPU.

Divergence note: the reference's ``ResourceListIgnoreZeroResources``
builds the *memory* quantity from ``r.MilliCPU`` (helper.go:340, an
upstream bug). We emit the correct memory value and cover the behavior
with tests; bit-parity is not owed to a bug that corrupts data.

Copy of ``crane_scheduler_tpu/topology/helper.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..cluster.state import Container, Pod
from ..framework.types import Resource
from ..utils.quantity import to_milli
from .types import (
    ANNOTATION_POD_CPU_POLICY,
    ANNOTATION_POD_TOPOLOGY_AWARENESS,
    ANNOTATION_POD_TOPOLOGY_RESULT,
    CPU_POLICY_NONE,
    SUPPORTED_CPU_POLICIES,
    ZONE_TYPE_NODE,
    Zone,
    ZoneResourceInfo,
    zones_from_json,
)


def is_pod_aware_of_topology(annotations) -> bool | None:
    """Tri-state pod awareness annotation (ref: helper.go:28-35)."""
    val = (annotations or {}).get(ANNOTATION_POD_TOPOLOGY_AWARENESS)
    if val is None:
        return None
    # strconv.ParseBool's exact accepted spellings.
    if val in ("1", "t", "T", "true", "TRUE", "True"):
        return True
    if val in ("0", "f", "F", "false", "FALSE", "False"):
        return False
    return None  # unparseable: same as absent


def get_pod_cpu_policy(annotations) -> str:
    """ref: helper.go:52-58 — only supported values count."""
    policy = (annotations or {}).get(ANNOTATION_POD_CPU_POLICY, "")
    return policy if policy in SUPPORTED_CPU_POLICIES else ""


def guaranteed_cpus(container: Container) -> int:
    """Whole guaranteed cores: requests == limits and integral
    (ref: helper.go:61-73)."""
    req = container.resources.requests.get("cpu")
    lim = container.resources.limits.get("cpu")
    req_milli = to_milli(req) if req is not None else 0
    lim_milli = to_milli(lim) if lim is not None else 0
    if req_milli != lim_milli or req_milli % 1000 != 0:
        return 0
    return req_milli // 1000


def get_pod_target_container_indices(pod: Pod) -> list[int]:
    """Containers whose CPUs can be pinned (ref: helper.go:38-49)."""
    if get_pod_cpu_policy(pod.annotations) == CPU_POLICY_NONE:
        return []
    return [i for i, c in enumerate(pod.containers) if guaranteed_cpus(c) > 0]


def get_pod_topology_result(pod: Pod) -> list[Zone]:
    """Decode the pod's result annotation (ref: helper.go:76-88)."""
    raw = (pod.annotations or {}).get(ANNOTATION_POD_TOPOLOGY_RESULT)
    if raw is None:
        return []
    return zones_from_json(raw) or []


def get_pod_numa_node_result(pod: Pod) -> list[Zone]:
    """Only Node-type zones (ref: helper.go:91-98)."""
    return [z for z in get_pod_topology_result(pod) if z.type == ZONE_TYPE_NODE]


class NumaNode:
    """Per-zone accounting (ref: helper.go:102-125)."""

    def __init__(self, zone: Zone):
        self.name = zone.name
        allocatable = zone.resources.allocatable if zone.resources else {}
        self.allocatable = Resource()
        self.allocatable.add(allocatable or {})
        self.requested = Resource()

    def add_resource(self, info: ZoneResourceInfo | None) -> None:
        """Existing pods consume their recorded *capacity*
        (ref: helper.go:119-124)."""
        if info is None:
            return
        self.requested.add(info.capacity or {})


@dataclass
class NodeWrapper:
    """Per-(pod, node) NUMA state for one scheduling cycle
    (ref: helper.go:127-171)."""

    node: str
    numa_nodes: list[NumaNode]
    get_assumed_pod_topology: object  # callable Pod -> list[Zone] (raises)
    topology_aware_resources: frozenset[str]
    aware: bool = False
    result: list[Zone] = field(default_factory=list)

    def add_pod(self, pod: Pod) -> None:
        """Account a placed pod's NUMA usage from its result annotation,
        falling back to the assumed cache (ref: helper.go:150-160)."""
        numa_result = get_pod_numa_node_result(pod)
        if not numa_result:
            try:
                numa_result = self.get_assumed_pod_topology(pod)
            except KeyError:
                return
        self.add_numa_resources(numa_result)

    def add_numa_resources(self, numa_result: list[Zone]) -> None:
        for zone in numa_result:
            for nn in self.numa_nodes:
                if nn.name == zone.name:
                    nn.add_resource(zone.resources)


def new_node_wrapper(
    node: str,
    resource_names: frozenset[str],
    zones,
    get_assumed_pod_topology,
) -> NodeWrapper:
    return NodeWrapper(
        node=node,
        numa_nodes=[NumaNode(z) for z in zones],
        get_assumed_pod_topology=get_assumed_pod_topology,
        topology_aware_resources=resource_names,
    )


def compute_container_specified_resource_request(
    pod: Pod, indices: list[int], names: frozenset[str]
) -> Resource:
    """Sum requests of the target containers, restricted to the
    topology-aware resource names (ref: helper.go:215-228)."""
    result = Resource()
    for idx in indices:
        container = pod.containers[idx]
        filtered = {
            name: quantity
            for name, quantity in container.resources.requests.items()
            if name in names
        }
        result.add(filtered)
    return result


def fits_request_for_numa_node(pod_request: Resource, numa_node: NumaNode) -> list[str]:
    """Insufficient-resource reasons; empty means fit
    (ref: helper.go:230-282)."""
    insufficient: list[str] = []
    allocatable, requested = numa_node.allocatable, numa_node.requested
    if (
        pod_request.milli_cpu == 0
        and pod_request.memory == 0
        and pod_request.ephemeral_storage == 0
        and not pod_request.scalar_resources
    ):
        return insufficient
    if pod_request.milli_cpu > allocatable.milli_cpu - requested.milli_cpu:
        insufficient.append("cpu")
    if pod_request.memory > allocatable.memory - requested.memory:
        insufficient.append("memory")
    if (
        pod_request.ephemeral_storage
        > allocatable.ephemeral_storage - requested.ephemeral_storage
    ):
        insufficient.append("ephemeral-storage")
    for name, quantity in pod_request.scalar_resources.items():
        if quantity > allocatable.scalar_resources.get(
            name, 0
        ) - requested.scalar_resources.get(name, 0):
            insufficient.append(name)
    return insufficient


def assign_request_for_numa_node(
    pod_request: Resource, numa_node: NumaNode
) -> tuple[Resource | None, bool]:
    """Take as much of the (mutable) remaining request as this zone can
    hold; True when fully satisfied (ref: helper.go:284-328)."""
    allocatable, requested = numa_node.allocatable, numa_node.requested
    if (
        pod_request.milli_cpu == 0
        and pod_request.memory == 0
        and pod_request.ephemeral_storage == 0
        and not pod_request.scalar_resources
    ):
        return None, False

    res = Resource()
    finished = True

    assigned = min(pod_request.milli_cpu, allocatable.milli_cpu - requested.milli_cpu)
    pod_request.milli_cpu -= assigned
    res.milli_cpu = assigned
    if pod_request.milli_cpu > 0:
        finished = False

    assigned = min(pod_request.memory, allocatable.memory - requested.memory)
    pod_request.memory -= assigned
    res.memory = assigned
    if pod_request.memory > 0:
        finished = False

    assigned = min(
        pod_request.ephemeral_storage,
        allocatable.ephemeral_storage - requested.ephemeral_storage,
    )
    pod_request.ephemeral_storage -= assigned
    res.ephemeral_storage = assigned
    if pod_request.ephemeral_storage > 0:
        finished = False

    for name, quantity in pod_request.scalar_resources.items():
        assigned = min(
            quantity,
            allocatable.scalar_resources.get(name, 0)
            - requested.scalar_resources.get(name, 0),
        )
        pod_request.scalar_resources[name] = quantity - assigned
        res.scalar_resources[name] = assigned
        if pod_request.scalar_resources[name] > 0:
            finished = False

    return res, finished


def resource_list_ignore_zero(r: Resource | None) -> dict[str, object]:
    """Non-zero Resource -> ResourceList (ref: helper.go:331-358; the
    reference's memory-from-MilliCPU bug is deliberately not reproduced)."""
    if r is None:
        return {}
    result: dict[str, object] = {}
    if r.milli_cpu > 0:
        result["cpu"] = f"{r.milli_cpu}m"
    if r.memory > 0:
        result["memory"] = str(r.memory)
    if r.allowed_pod_number > 0:
        result["pods"] = str(r.allowed_pod_number)
    if r.ephemeral_storage > 0:
        result["ephemeral-storage"] = str(r.ephemeral_storage)
    for name, quantity in r.scalar_resources.items():
        if quantity > 0:
            result[name] = str(quantity)
    return result


def assign_topology_result(nw: NodeWrapper, request: Resource) -> None:
    """Zone assignment (ref: helper.go:173-212): sort zones by free CPU
    descending; aware pods take one whole zone; non-aware pods greedily
    pack across zones with allocatable CPU rounded down to whole cores;
    the result sorts by zone name."""
    nw.numa_nodes.sort(
        key=lambda nn: nn.allocatable.milli_cpu - nn.requested.milli_cpu,
        reverse=True,
    )

    if nw.aware:
        nw.result = [
            Zone(
                name=nw.numa_nodes[0].name,
                type=ZONE_TYPE_NODE,
                resources=ZoneResourceInfo(capacity=resource_list_ignore_zero(request)),
            )
        ]
        return

    for nn in nw.numa_nodes:
        nn.allocatable.milli_cpu = nn.allocatable.milli_cpu // 1000 * 1000
        res, finished = assign_request_for_numa_node(request, nn)
        capacity = resource_list_ignore_zero(res)
        if capacity:
            nw.result.append(
                Zone(
                    name=nn.name,
                    type=ZONE_TYPE_NODE,
                    resources=ZoneResourceInfo(capacity=capacity),
                )
            )
        if finished:
            break
    nw.result.sort(key=lambda z: z.name)
