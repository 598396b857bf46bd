"""Internal DynamicSchedulerPolicy model.

Copy of ``crane_scheduler_tpu/policy/types.py``.

Mirrors the reference's internal policy types
(ref: pkg/plugins/apis/policy/types.go:9-39): a spec with four ordered
lists — syncPolicy (metric name + refresh period), predicate (metric name +
max limit), priority (metric name + weight), hotValue (time range + count).
List order is semantically meaningful: priority scores accumulate in list
order (float addition order affects bit-exact results) and hot-value terms
sum in list order with per-entry integer division.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class SyncPolicy:
    name: str
    period_seconds: float  # ref: SyncPolicy.Period (metav1.Duration)


@dataclass(frozen=True)
class PredicatePolicy:
    name: str
    max_limit_percent: float  # ref: PredicatePolicy.MaxLimitPecent (sic)


@dataclass(frozen=True)
class PriorityPolicy:
    name: str
    weight: float


@dataclass(frozen=True)
class HotValuePolicy:
    time_range_seconds: float  # ref: HotValuePolicy.TimeRange
    count: int


@dataclass(frozen=True)
class PolicySpec:
    sync_period: tuple[SyncPolicy, ...] = ()
    predicate: tuple[PredicatePolicy, ...] = ()
    priority: tuple[PriorityPolicy, ...] = ()
    hot_value: tuple[HotValuePolicy, ...] = ()


@dataclass(frozen=True)
class DynamicSchedulerPolicy:
    spec: PolicySpec = field(default_factory=PolicySpec)
    api_version: str = "scheduler.policy.crane.io/v1alpha1"
    kind: str = "DynamicSchedulerPolicy"


# The canonical default policy shipped with the reference
# (ref: deploy/manifests/dynamic/policy.yaml): 6 sync metrics at 3m/15m/3h,
# 4 predicate thresholds 0.65/0.75, 6 priority weights 0.2/0.3/0.5,
# hotValue 5m/5 + 1m/2.
DEFAULT_POLICY = DynamicSchedulerPolicy(
    spec=PolicySpec(
        sync_period=(
            SyncPolicy("cpu_usage_avg_5m", 180.0),
            SyncPolicy("cpu_usage_max_avg_1h", 900.0),
            SyncPolicy("cpu_usage_max_avg_1d", 10800.0),
            SyncPolicy("mem_usage_avg_5m", 180.0),
            SyncPolicy("mem_usage_max_avg_1h", 900.0),
            SyncPolicy("mem_usage_max_avg_1d", 10800.0),
        ),
        predicate=(
            PredicatePolicy("cpu_usage_avg_5m", 0.65),
            PredicatePolicy("cpu_usage_max_avg_1h", 0.75),
            PredicatePolicy("mem_usage_avg_5m", 0.65),
            PredicatePolicy("mem_usage_max_avg_1h", 0.75),
        ),
        priority=(
            PriorityPolicy("cpu_usage_avg_5m", 0.2),
            PriorityPolicy("cpu_usage_max_avg_1h", 0.3),
            PriorityPolicy("cpu_usage_max_avg_1d", 0.5),
            PriorityPolicy("mem_usage_avg_5m", 0.2),
            PriorityPolicy("mem_usage_max_avg_1h", 0.3),
            PriorityPolicy("mem_usage_max_avg_1d", 0.5),
        ),
        hot_value=(
            HotValuePolicy(300.0, 5),
            HotValuePolicy(60.0, 2),
        ),
    )
)
