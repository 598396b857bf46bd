"""NodeResourcesFit-equivalent framework Filter.

ref: pkg/scheduler/framework/plugins/noderesources/fit.go — the stock
allocatable-capacity predicate the rebuilt framework lacked: without
it, drip mode happily binds onto a node with zero free CPU. No
daemonset bypass (stock has none); zero-request pods pass trivially on
every node that still has a pod slot.

Copy of ``crane_scheduler_tpu/fit/plugin.py``.
"""

from __future__ import annotations

from ..cluster.state import Pod
from ..framework.types import CycleState, NodeInfo, Status
from .tracker import FitTracker, pod_fit_request

PLUGIN_NAME = "NodeResourcesFit"

_STATE_KEY = "fit/pod-request"


class ResourceFitPlugin:
    def __init__(self, tracker: FitTracker):
        self.tracker = tracker

    @property
    def name(self) -> str:
        return PLUGIN_NAME

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        if node_info.node is None:
            return Status.error("node not found")
        # compute the effective request once per cycle, not per node
        try:
            request = state.read(_STATE_KEY)
        except KeyError:
            self.tracker.refresh()
            request = pod_fit_request(pod)
            state.write(_STATE_KEY, request)
        ok, reason = self.tracker.fits(pod, node_info.node.name, request)
        if not ok:
            return Status.unschedulable(
                f"Node {node_info.node.name} fit failure: {reason}"
            )
        return Status.success()
