"""Cluster-wide Filter/Score columns for the drip fast path.

The per-pod ("drip") scheduler needs the same verdicts the scalar
oracle produces node-by-node, but as whole-cluster numpy columns it can
cache across pods: a feasibility mask, the failing-predicate index each
infeasible node would report, and the Dynamic score. The score/filter
math is ``hybrid.score_rows_f64`` — the IEEE-double operation sequence
already validated bit-identical to ``scorer.oracle`` — so the only new
logic here is first-failing-predicate tracking, which the scalar
``filter_node`` reports as the failure message's metric name
(ref: plugins.go:39-69 — the scan returns on the FIRST overloaded
predicate in policy order).

Copy of ``crane_scheduler_tpu/scorer/columns.py``: numpy float64 on the
host, as in the reference.
"""

from __future__ import annotations

import numpy as np

from ..policy.compile import PolicyTensors
from .hybrid import score_rows_f64


def drip_filter_score_columns(
    tensors: PolicyTensors,
    values: np.ndarray,
    ts: np.ndarray,
    hot_value: np.ndarray,
    hot_ts: np.ndarray,
    now: float,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(schedulable[N] bool, fail_entry[N] int32, score[N] int32)``.

    ``fail_entry`` is the index into ``tensors.pred_idx`` of the first
    overloaded predicate entry per node (-1 when the node passes) —
    enough to reconstruct the scalar Filter's failure message lazily
    without re-walking annotations.
    """
    n = values.shape[0]
    fail_entry = np.full((n,), -1, dtype=np.int32)
    for p in range(len(tensors.pred_idx)):
        active = tensors.pred_active[p]
        if active <= 0:
            continue  # entry skipped (ref: plugins.go:57-61)
        threshold = tensors.pred_threshold[p]
        if threshold == 0:
            continue  # zero threshold disables (ref: stats.go:102-105)
        col = tensors.pred_idx[p]
        u = values[:, col]
        fresh = now < ts[:, col] + active
        with np.errstate(invalid="ignore"):
            # fail-open: stale/missing/negative never overloads; NaN
            # passes both comparisons exactly as in the oracle
            over = fresh & ~(u < 0) & (u > threshold)
        first = over & (fail_entry < 0)
        if first.any():
            fail_entry[first] = p
    schedulable, score = score_rows_f64(
        values, ts, hot_value, hot_ts, float(now), tensors
    )
    return schedulable, fail_entry, score


def fail_metric_name(tensors: PolicyTensors, entry: int) -> str:
    """Metric name the scalar Filter reports for ``fail_entry`` value."""
    return tensors.metric_names[int(tensors.pred_idx[int(entry)])]


def fail_metric_names(tensors: PolicyTensors) -> list[str]:
    """All ``fail_entry -> metric name`` resolutions at once — the
    vectorized ``reason_counts`` path does one table build per policy
    instead of a per-node ``fail_metric_name`` call."""
    return [
        tensors.metric_names[int(col)] for col in tensors.pred_idx
    ]
