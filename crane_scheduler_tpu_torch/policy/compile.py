"""Compile a DynamicSchedulerPolicy into tensor constants.

Copy of ``crane_scheduler_tpu/policy/compile.py``.

The reference walks Go slices per node per scheduling cycle
(ref: pkg/plugins/dynamic/stats.go:94-150). Here the policy is compiled
once into small dense vectors — metric column indices, thresholds, weights,
staleness windows — that parameterize a single batched tensor expression
over the whole node-by-metric load matrix.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .types import DynamicSchedulerPolicy
from ..constants import EXTRA_ACTIVE_PERIOD_SECONDS


@dataclass(frozen=True)
class PolicyTensors:
    """Dense form of a DynamicSchedulerPolicy.

    Axis conventions: ``M`` metric columns, ``P`` predicate entries,
    ``K`` priority entries, ``H`` hot-value entries. Entry arrays preserve
    policy list order — priority accumulation order is bit-significant.
    """

    metric_names: tuple[str, ...]
    metric_index: dict  # name -> column
    # Per-metric first nonzero sync period (+0 when absent); seconds.
    sync_seconds: np.ndarray  # [M] f64
    # Per-metric staleness window: first nonzero period + 5m, else 0 (=disabled)
    # (ref: stats.go:140-150 — zero-period entries are skipped by the scan).
    active_seconds: np.ndarray  # [M] f64
    pred_idx: np.ndarray  # [P] i32 metric column per predicate entry
    pred_threshold: np.ndarray  # [P] f64
    pred_active: np.ndarray  # [P] f64 staleness window per entry; 0 = entry skipped
    prio_idx: np.ndarray  # [K] i32
    prio_weight: np.ndarray  # [K] f64
    prio_active: np.ndarray  # [K] f64; 0 = entry scores 0 (weight still counts)
    weight_sum: float  # Σ weights accumulated in list order (f64)
    hv_range_seconds: np.ndarray  # [H] f64
    hv_count: np.ndarray  # [H] i64

    @property
    def num_metrics(self) -> int:
        return len(self.metric_names)


def compile_policy(policy: DynamicSchedulerPolicy) -> PolicyTensors:
    spec = policy.spec

    # Metric universe: first-appearance order over sync, predicate, priority.
    names: list[str] = []
    index: dict[str, int] = {}

    def intern(name: str) -> int:
        if name not in index:
            index[name] = len(names)
            names.append(name)
        return index[name]

    for sp in spec.sync_period:
        intern(sp.name)
    for pp in spec.predicate:
        intern(pp.name)
    for pr in spec.priority:
        intern(pr.name)

    m = len(names)
    sync_seconds = np.zeros((m,), dtype=np.float64)
    active_seconds = np.zeros((m,), dtype=np.float64)
    claimed: set[int] = set()
    for sp in spec.sync_period:
        col = index[sp.name]
        # First nonzero-period entry per name wins (ref: stats.go:140-150).
        # Track claims explicitly: a claimed window may itself compute to 0
        # (e.g. a pathological -5m period) and must not be overwritten.
        if col not in claimed and sp.period_seconds != 0.0:
            claimed.add(col)
            sync_seconds[col] = sp.period_seconds
            active_seconds[col] = sp.period_seconds + EXTRA_ACTIVE_PERIOD_SECONDS

    pred_idx = np.array([index[p.name] for p in spec.predicate], dtype=np.int32)
    pred_threshold = np.array([p.max_limit_percent for p in spec.predicate], dtype=np.float64)
    pred_active = (
        active_seconds[pred_idx] if len(pred_idx) else np.zeros((0,), dtype=np.float64)
    )

    prio_idx = np.array([index[p.name] for p in spec.priority], dtype=np.int32)
    prio_weight = np.array([p.weight for p in spec.priority], dtype=np.float64)
    prio_active = (
        active_seconds[prio_idx] if len(prio_idx) else np.zeros((0,), dtype=np.float64)
    )

    weight_sum = 0.0
    for p in spec.priority:
        weight_sum += p.weight  # list order, matching Go accumulation

    hv_range_seconds = np.array(
        [h.time_range_seconds for h in spec.hot_value], dtype=np.float64
    )
    hv_count = np.array([h.count for h in spec.hot_value], dtype=np.int64)

    return PolicyTensors(
        metric_names=tuple(names),
        metric_index=dict(index),
        sync_seconds=sync_seconds,
        active_seconds=active_seconds,
        pred_idx=pred_idx,
        pred_threshold=pred_threshold,
        pred_active=np.asarray(pred_active, dtype=np.float64),
        prio_idx=prio_idx,
        prio_weight=prio_weight,
        prio_active=np.asarray(prio_active, dtype=np.float64),
        weight_sum=weight_sum,
        hv_range_seconds=hv_range_seconds,
        hv_count=hv_count,
    )
