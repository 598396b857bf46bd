"""The Dynamic plugin: load-aware Filter + Score.

ref: pkg/plugins/dynamic/plugins.go — the in-process scalar path, reading
node annotations from the informer snapshot through the parity oracle.
This is the safe fallback scorer; the batched path
(``framework.BatchScheduler``) computes the identical function over the
whole cluster at once and is validated bit-for-bit against this plugin.

Degraded mode: when the attached ``DegradedModeController``
reports that most of the cluster's load annotations are stale, the
per-node fail-open in the oracle stops being a safety net and becomes
noise — every node silently collapses to the neutral score. Instead of
that drift, the plugin makes one explicit transition: Filter fails open
(the separately-registered ``ResourceFitPlugin`` keeps guarding
allocatable capacity) and Score switches to spread-only (fewest pods
wins), which needs no annotations at all. ``degraded`` is duck-typed: any
object with an ``active`` attribute.

Copy of ``crane_scheduler_tpu/plugins/dynamic.py``.
"""

from __future__ import annotations

import time

from ..cluster.state import Pod
from ..constants import MAX_NODE_SCORE, MIN_NODE_SCORE
from ..framework.types import CycleState, NodeInfo, Status
from ..policy.types import DynamicSchedulerPolicy
from ..policy.v1alpha1 import load_policy_from_file
from ..scorer import oracle

PLUGIN_NAME = "Dynamic"


def spread_score(node_info: NodeInfo) -> int:
    """Annotation-free fallback score: fewest pods wins, clamped to the
    framework's [MIN_NODE_SCORE, MAX_NODE_SCORE] band."""
    return max(MIN_NODE_SCORE, MAX_NODE_SCORE - len(node_info.pods))


class DynamicPlugin:
    def __init__(self, policy: DynamicSchedulerPolicy, clock=time.time, degraded=None):
        self.policy = policy
        self._clock = clock
        self.degraded = degraded  # anything with ``.active``, or None

    @classmethod
    def from_policy_file(cls, path: str) -> "DynamicPlugin":
        """ref: plugins.go:105-120 (DynamicArgs.PolicyConfigPath)."""
        return cls(load_policy_from_file(path))

    @property
    def name(self) -> str:
        return PLUGIN_NAME

    def _degraded_active(self) -> bool:
        return self.degraded is not None and self.degraded.active

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        """ref: plugins.go:39-69."""
        if pod.is_daemonset_pod():
            return Status.success()
        if node_info.node is None:
            return Status.error("node not found")
        if self._degraded_active():
            # the overload predicate would be judging stale data; fail
            # open and let ResourceFit carry the safety check
            return Status.success()
        anno = node_info.node.annotations or {}
        ok, metric = oracle.filter_node(anno, self.policy.spec, self._clock())
        if not ok:
            return Status.unschedulable(
                f"Load[{metric}] of node[{node_info.node.name}] is too high"
            )
        return Status.success()

    def score(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> tuple[int, Status]:
        """ref: plugins.go:73-98."""
        if node_info.node is None:
            return 0, Status.error("node not found")
        if self._degraded_active():
            return spread_score(node_info), Status.success()
        anno = node_info.node.annotations or {}
        return oracle.score_node(anno, self.policy.spec, self._clock()), Status.success()
