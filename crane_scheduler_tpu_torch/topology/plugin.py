"""TopologyMatch: NUMA-aware PreFilter/Filter/Score/Reserve/PreBind.

ref: pkg/plugins/noderesourcetopology/{plugin,filter,scorer,reserver,
binder}.go. The cycle:

  PreFilter  — compute guaranteed-CPU container indices + their summed
               topology-aware resource request into CycleState.
  Filter     — per node: skip DaemonSet pods / no target containers; get
               the node's NRT CR (missing => Unschedulable); only enforce
               when CPUManagerPolicy is Static; rebuild per-zone usage
               from placed pods' result annotations (assumed-cache
               fallback); aware pods need one zone fitting the whole
               request; record the greedy zone assignment per node.
  Score      — 100 / len(assigned zones): fewer zones crossed is better.
  Reserve    — persist the chosen ZoneList + assume the pod.
  PreBind    — write the result annotation onto the pod.
  Unreserve  — forget the assumed pod.

Copy of ``crane_scheduler_tpu/topology/plugin.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..cluster.state import ClusterState, Pod
from ..constants import MAX_NODE_SCORE
from ..framework.types import CycleState, NodeInfo, Resource, Status
from .cache import PodTopologyCache
from .helper import (
    assign_topology_result,
    compute_container_specified_resource_request,
    fits_request_for_numa_node,
    get_pod_target_container_indices,
    is_pod_aware_of_topology,
    new_node_wrapper,
    NodeWrapper,
)
from .types import (
    ANNOTATION_POD_TOPOLOGY_RESULT,
    CPU_MANAGER_POLICY_STATIC,
    NRTLister,
    TOPOLOGY_MANAGER_POLICY_SINGLE_NUMA_POD,
    NodeResourceTopology,
    zones_to_json,
)

PLUGIN_NAME = "NodeResourceTopologyMatch"
STATE_KEY = PLUGIN_NAME  # ref: plugin.go state key

ERR_NUMA_INSUFFICIENT = "node(s) had insufficient resource of NUMA node"
ERR_FAILED_TO_GET_NRT = "node(s) failed to get NRT"

DEFAULT_TOPOLOGY_AWARE_RESOURCES = frozenset({"cpu"})  # ref: v1beta2/defaults.go


@dataclass
class _GroupContext:
    """State for one node's grouped bind (see ``group_context``)."""

    s: "_StateData"
    nw: NodeWrapper
    cr_order: list


@dataclass
class _StateData:
    """ref: plugin.go:93-122."""

    aware: bool | None
    target_container_indices: list[int]
    target_container_resource: Resource
    pod_topology_by_node: dict[str, NodeWrapper] = field(default_factory=dict)
    topology_result: list = field(default_factory=list)


def is_node_aware_of_topology(nrt: NodeResourceTopology) -> bool:
    """ref: filter.go:125-127."""
    return (
        nrt.crane_manager_policy.topology_manager_policy
        == TOPOLOGY_MANAGER_POLICY_SINGLE_NUMA_POD
    )


class TopologyMatch:
    def __init__(
        self,
        lister: NRTLister,
        cluster: ClusterState | None = None,
        topology_aware_resources: frozenset[str] = DEFAULT_TOPOLOGY_AWARE_RESOURCES,
        cache: PodTopologyCache | None = None,
    ):
        self.lister = lister
        self.cluster = cluster
        self.topology_aware_resources = frozenset(topology_aware_resources)
        self.cache = cache or PodTopologyCache()

    @property
    def name(self) -> str:
        return PLUGIN_NAME

    # -- PreFilter (ref: filter.go:20-37) ----------------------------------

    def pre_filter(self, state: CycleState, pod: Pod) -> Status:
        indices: list[int] = []
        if "cpu" in self.topology_aware_resources:
            indices = get_pod_target_container_indices(pod)
        resources = compute_container_specified_resource_request(
            pod, indices, self.topology_aware_resources
        )
        state.write(
            STATE_KEY,
            _StateData(
                aware=is_pod_aware_of_topology(pod.annotations),
                target_container_indices=indices,
                target_container_resource=resources,
            ),
        )
        return Status.success()

    def _get_state(self, state: CycleState) -> _StateData | None:
        try:
            data = state.read(STATE_KEY)
        except KeyError:
            return None
        return data if isinstance(data, _StateData) else None

    # -- Filter (ref: filter.go:45-86) -------------------------------------

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        s = self._get_state(state)
        if s is None:
            return Status.error("no prefilter state")
        if node_info.node is None:
            return Status.error("node(s) not found")
        if pod.is_daemonset_pod() or not s.target_container_indices:
            return Status.success()
        try:
            nrt = self.lister.get(node_info.node.name)
        except KeyError:
            return Status.unschedulable(ERR_FAILED_TO_GET_NRT)
        # let kubelet handle cpuset unless the static policy is on
        if nrt.crane_manager_policy.cpu_manager_policy != CPU_MANAGER_POLICY_STATIC:
            return Status.success()

        nw = self._initialize_node_wrapper(s, node_info, nrt)
        if nw.aware:
            status = self._filter_numa_node_resource(s, nw)
            if status is not None:
                return status
        assign_topology_result(nw, s.target_container_resource.clone())

        with state.lock():
            s.pod_topology_by_node[nw.node] = nw
        return Status.success()

    def _initialize_node_wrapper(self, s: _StateData, node_info, nrt) -> NodeWrapper:
        """ref: filter.go:88-105."""
        nw = new_node_wrapper(
            node_info.node.name,
            self.topology_aware_resources,
            nrt.zones,
            self.cache.get_pod_topology,
        )
        for pod in node_info.pods:
            nw.add_pod(pod)
        # pod-specified awareness overrides the node's
        nw.aware = s.aware if s.aware is not None else is_node_aware_of_topology(nrt)
        return nw

    def _filter_numa_node_resource(self, s: _StateData, nw: NodeWrapper) -> Status | None:
        """ref: filter.go:107-123 — keep only zones fitting the whole
        request; none left => Unschedulable."""
        fitting = [
            nn
            for nn in nw.numa_nodes
            if not fits_request_for_numa_node(s.target_container_resource, nn)
        ]
        if not fitting:
            return Status.unschedulable(ERR_NUMA_INSUFFICIENT)
        nw.numa_nodes = fitting
        return None

    # -- grouped binds (the batch scheduler's per-node fast path) ----------

    def group_context(self, template: Pod, node, pods):
        """Filter-gate evaluation ONCE for a class-homogeneous group of
        pods headed to one node (every pod shares the template's
        guaranteed-CPU request and awareness — the scheduler groups by
        ``_class_key``). Returns:

        - ``None`` — the plugin no-ops for this class or node (DaemonSet
          / no guaranteed-CPU containers / non-Static policy), exactly
          the per-pod Filter's early successes (filter.go:60-71);
        - ``"missing_nrt"`` — Unschedulable for the whole group
          (filter.go:56-58);
        - a context for ``group_assign`` otherwise.

        The semantics here ARE the per-pod Filter's, restructured so the
        node wrapper builds once; ``group_assign`` then evolves it copy
        by copy. Equivalence with per-pod Filter->Reserve is pinned by
        randomized tests (tests/test_torch_numa.py)."""
        state = CycleState()
        self.pre_filter(state, template)
        s = self._get_state(state)
        if s is None or template.is_daemonset_pod() or not s.target_container_indices:
            return None
        try:
            nrt = self.lister.get(node.name)
        except KeyError:
            return "missing_nrt"
        if nrt.crane_manager_policy.cpu_manager_policy != CPU_MANAGER_POLICY_STATIC:
            return None
        nw = self._initialize_node_wrapper(
            s, NodeInfo(node=node, pods=pods), nrt
        )
        # a fresh per-pod rebuild starts from the CR's zone order and the
        # greedy sort is STABLE — keep the CR order so ties break like a
        # rebuild would
        return _GroupContext(s=s, nw=nw, cr_order=list(nw.numa_nodes))

    def group_assign(self, ctx) -> list | None:
        """One copy's Filter-fit + zone assignment against the group's
        evolving wrapper: None = Unschedulable (ERR_NUMA_INSUFFICIENT),
        else the zone result — already folded into the wrapper's usage,
        which is exactly what the next per-pod rebuild would read back
        from this copy's result annotation."""
        s, nw = ctx.s, ctx.nw
        if nw.aware:
            fitting = [
                nn
                for nn in ctx.cr_order
                if not fits_request_for_numa_node(s.target_container_resource, nn)
            ]
            if not fitting:
                return None
            nw.numa_nodes = fitting
        else:
            nw.numa_nodes = list(ctx.cr_order)
        nw.result = []
        assign_topology_result(nw, s.target_container_resource.clone())
        result = list(nw.result)
        if result:
            nw.add_numa_resources(result)
        return result

    # -- a window of pods at once (the batched drip window) ----------------

    def commit_results(self, entries, now: float | None = None) -> bool:
        """Reserve and PreBind for a window's pods at once: ``entries`` are
        ``(pod, zones, annotation)`` triples (the zone result and its
        ``zones_to_json``), assumed in the cache in one lock hold, then
        written onto the pods in one. Writes nothing and returns False
        when a pod is already assumed or missing from the cluster: the
        per-pod cycle's Reserve or PreBind fails there, and decides such
        a window."""
        if self.cluster is None:
            return False
        keys = [pod.key() for pod, _zones, _raw in entries]
        if self.cache.assumed(keys) or any(self.cluster.get_pod(k) is None for k in keys):
            return False
        self.cache.assume_pods(((pod, zones) for pod, zones, _raw in entries), now)
        self.cluster.patch_pod_annotations(
            (key, ANNOTATION_POD_TOPOLOGY_RESULT, raw)
            for key, (_pod, _zones, raw) in zip(keys, entries))
        return True

    # -- Score (ref: scorer.go:11-29) --------------------------------------

    def score(self, state: CycleState, pod: Pod, node_name: str) -> tuple[int, Status]:
        s = self._get_state(state)
        if s is None:
            return 0, Status.error("no prefilter state")
        nw = s.pod_topology_by_node.get(node_name)
        if nw is None:
            return 0, Status.success()
        return MAX_NODE_SCORE // len(nw.result), Status.success()

    # -- Reserve / Unreserve (ref: reserver.go) ----------------------------

    def reserve(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        s = self._get_state(state)
        if s is None:
            return Status.error("no prefilter state")
        nw = s.pod_topology_by_node.get(node_name)
        if nw is None:
            return Status.success()
        if not nw.result:
            return Status.error("node(s) topology result is empty")
        s.topology_result = nw.result
        try:
            self.cache.assume_pod(pod, s.topology_result)
        except KeyError as e:
            return Status.error(str(e))
        return Status.success()

    def unreserve(self, state: CycleState, pod: Pod, node_name: str) -> None:
        s = self._get_state(state)
        if s is None:
            return
        if node_name not in s.pod_topology_by_node:
            return
        self.cache.forget_pod(pod)

    # -- PreBind (ref: binder.go:19-65) ------------------------------------

    def pre_bind(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        s = self._get_state(state)
        if s is None:
            return Status.error("no prefilter state")
        if not s.topology_result:
            return Status.success()
        if self.cluster is None:
            return Status.error("no cluster client for PreBind")
        ok = self.cluster.patch_pod_annotation(
            pod.key(), ANNOTATION_POD_TOPOLOGY_RESULT, zones_to_json(s.topology_result)
        )
        if not ok:
            return Status.error(f"pod {pod.key()} not found")
        return Status.success()
