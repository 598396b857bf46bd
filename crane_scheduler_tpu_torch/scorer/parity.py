"""Shared bit-for-bit parity gate against the f64/Go semantics.

Copy of ``crane_scheduler_tpu/scorer/parity.py``.

Device placements must match in-process Score() placements bit-for-bit
(ref semantics: pkg/plugins/dynamic/stats.go:114-138). ``chip_smoke.py``
gates every burst on this module: exact f64 verdicts and scores from the
host re-score, and counts from the numpy water-filling twin.
"""

from __future__ import annotations

import numpy as np

from .hybrid import score_rows_f64
from .topk import gang_assign_host


class ParityError(AssertionError):
    """Device results diverged from the exact f64/Go host semantics."""


def f64_verdicts(values, ts, hot_value, hot_ts, node_valid, now, tensors):
    """Exact f64 filter verdicts + scores with invalid rows masked the
    way the device step masks them (unschedulable, score 0)."""
    sched64, score64 = score_rows_f64(values, ts, hot_value, hot_ts, now, tensors)
    node_valid = np.asarray(node_valid, bool)
    return sched64 & node_valid, np.where(node_valid, score64, 0)


def check_placement_parity(
    *,
    values,
    ts,
    hot_value,
    hot_ts,
    node_valid,
    now,
    tensors,
    schedulable,
    scores,
    counts,
    num_pods,
    capacity=None,
    unassigned=None,
    offsets=None,
    dynamic_weight: int = 1,
    max_offset: int = 0,
    prior=None,
):
    """Raise ``ParityError`` unless the device verdicts, scores, and
    per-node placement counts equal the exact f64 scoring + host
    water-filling on the same inputs. ``offsets``/``dynamic_weight``/
    ``max_offset``/``prior`` must mirror the gang parameters the device
    step solved with (combined-score mode); the defaults are the plain
    Dynamic-score domain. Returns the oracle
    ``(sched64, score64, gang_result)`` for further inspection."""
    sched64, score64 = f64_verdicts(
        values, ts, hot_value, hot_ts, node_valid, now, tensors
    )
    if not (np.asarray(schedulable, bool) == sched64).all():
        raise ParityError("device filter verdicts != f64 oracle")
    dev_scores = np.asarray(scores)
    if not (dev_scores == score64).all():
        raise ParityError(f"{int((dev_scores != score64).sum())} device scores != f64 oracle")
    want = gang_assign_host(
        score64, sched64, num_pods, tensors.hv_count, capacity=capacity,
        offsets=offsets, dynamic_weight=dynamic_weight,
        max_offset=max_offset, prior=prior,
    )
    if not (np.asarray(counts) == np.asarray(want.counts)).all():
        raise ParityError("device placements != f64 water-filling")
    if unassigned is not None and int(unassigned) != int(want.unassigned):
        raise ParityError("device unassigned count != f64 water-filling")
    return sched64, score64, want
