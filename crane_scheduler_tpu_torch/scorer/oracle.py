"""Scalar reference scorer — the bit-exact parity oracle.

Copy of ``crane_scheduler_tpu/scorer/oracle.py``.

A pure-Python float64 transliteration of the Dynamic plugin's semantics
(ref: pkg/plugins/dynamic/stats.go, plugins.go). Every quirk is preserved
deliberately, because the batched TPU scorer is validated bit-for-bit
against this module:

- **fail-open**: any usage-read error (missing key, malformed value, stale
  or unparseable timestamp, negative value) means "not overloaded" for
  Filter (ref: stats.go:96-99) and a 0 contribution for Score.
- **zero threshold disables** a predicate entry (ref: stats.go:102-105).
- **weight counted on error**: a priority entry whose usage can't be read
  still adds its weight to the denominator (ref: stats.go:122-137 — the
  error branch does not skip ``weight += ``).
- **Go int truncation** toward zero for ``int(score/weight)`` and
  ``int(hotValue*10)`` (ref: stats.go:135, plugins.go:91).
- **hot value** read from the ``node_hot_value`` annotation with a fixed 5m
  validity window (ref: stats.go:152-166).
- priority entries whose metric has no (nonzero-period) syncPolicy entry
  score 0 with weight counted (ref: stats.go:80-84, 140-150).

All functions take an explicit ``now`` (epoch seconds) so behavior is a
pure function of (annotations, policy, now).
"""

from __future__ import annotations

import math

from ..loadstore.codec import go_parse_float
from ..policy.types import PolicySpec, PredicatePolicy, PriorityPolicy, SyncPolicy
from ..utils.score import go_trunc, normalize_score
from ..utils.timeutil import parse_local_time

from ..constants import (
    EXTRA_ACTIVE_PERIOD_SECONDS as EXTRA_ACTIVE_PERIOD,
    HOT_VALUE_ACTIVE_PERIOD_SECONDS as DEFAULT_HOT_VALUE_ACTIVE_PERIOD,
    MAX_NODE_SCORE,
    MIN_NODE_SCORE,
    NODE_HOT_VALUE_KEY as NODE_HOT_VALUE,
)


class UsageError(Exception):
    """A usage annotation could not be read (any fail-open condition)."""


def in_active_period(update_time_str: str, active_duration: float, now: float) -> bool:
    """ref: stats.go:30-49 — strict ``now < ts + activeDuration``."""
    ts = parse_local_time(update_time_str)
    if ts is None:
        return False
    return now < ts + active_duration


def get_resource_usage(
    anno: dict[str, str], key: str, active_duration: float, now: float
) -> float:
    """ref: stats.go:51-76. Raises UsageError on any invalid condition."""
    raw = anno.get(key)
    if raw is None:
        raise UsageError(f"key[{key}] not found")
    parts = raw.split(",")
    if len(parts) != 2:
        raise UsageError(f"illegal value: {raw}")
    if not in_active_period(parts[1], active_duration, now):
        raise UsageError(f"timestamp[{raw}] is expired")
    value = go_parse_float(parts[0])
    if value is None:
        raise UsageError(f"failed to parse float[{parts[0]}]")
    if value < 0:  # NaN compares False, i.e. NaN passes — as in Go
        raise UsageError(f"illegal value: {raw}")
    return value


def get_active_duration(sync_period: tuple[SyncPolicy, ...], name: str) -> float:
    """First matching nonzero-period entry + 5m; 0.0 means "no valid entry"
    (ref: stats.go:140-150 — the Go version returns (0, err); callers treat
    err and 0 identically)."""
    for sp in sync_period:
        if sp.name == name and sp.period_seconds != 0:
            return sp.period_seconds + EXTRA_ACTIVE_PERIOD
    return 0.0


def is_overload(
    anno: dict[str, str],
    predicate: PredicatePolicy,
    active_duration: float,
    now: float,
) -> bool:
    """ref: stats.go:94-112."""
    try:
        usage = get_resource_usage(anno, predicate.name, active_duration, now)
    except UsageError:
        return False  # fail-open
    if predicate.max_limit_percent == 0:
        return False  # zero threshold disables this entry
    return usage > predicate.max_limit_percent  # NaN > t is False


def get_score(
    anno: dict[str, str], priority: PriorityPolicy, spec: PolicySpec, now: float
) -> float:
    """ref: stats.go:78-92. Raises UsageError when the entry contributes 0."""
    active_duration = get_active_duration(spec.sync_period, priority.name)
    if active_duration == 0:
        raise UsageError(f"no active duration for resource[{priority.name}]")
    usage = get_resource_usage(anno, priority.name, active_duration, now)
    return (1.0 - usage) * priority.weight * float(MAX_NODE_SCORE)


def get_node_score(anno: dict[str, str], spec: PolicySpec, now: float) -> int:
    """ref: stats.go:114-138."""
    if len(spec.priority) == 0:
        return 0
    score = 0.0
    weight = 0.0
    for priority in spec.priority:
        try:
            priority_score = get_score(anno, priority, spec, now)
        except UsageError:
            priority_score = 0.0
        weight += priority.weight
        score += priority_score
    if weight == 0.0:
        # Go float division: 0/0 and NaN/0 -> NaN, x/0 -> ±Inf; all
        # truncate to int64-min on amd64 (see go_trunc).
        if score == 0.0 or math.isnan(score):
            quotient = math.nan
        else:
            quotient = math.copysign(math.inf, score)
    else:
        quotient = score / weight
    return go_trunc(quotient)


def get_node_hot_value(anno: dict[str, str] | None, now: float) -> float:
    """ref: stats.go:152-166."""
    if anno is None:
        return 0.0
    try:
        return get_resource_usage(anno, NODE_HOT_VALUE, DEFAULT_HOT_VALUE_ACTIVE_PERIOD, now)
    except UsageError:
        return 0.0


def filter_node(
    anno: dict[str, str] | None,
    spec: PolicySpec,
    now: float,
    is_daemonset_pod: bool = False,
) -> tuple[bool, str]:
    """Dynamic Filter: returns (schedulable, failing_metric_name)
    (ref: plugins.go:39-69)."""
    if is_daemonset_pod:
        return True, ""
    if anno is None:
        anno = {}
    for predicate in spec.predicate:
        active_duration = get_active_duration(spec.sync_period, predicate.name)
        if active_duration == 0:
            continue  # ref: plugins.go:57-61
        if is_overload(anno, predicate, active_duration, now):
            return False, predicate.name
    return True, ""


def score_node(anno: dict[str, str] | None, spec: PolicySpec, now: float) -> int:
    """Dynamic Score: base score minus hot-value penalty, clamped to
    [0, 100] (ref: plugins.go:73-98)."""
    if anno is None:
        anno = {}
    score = get_node_score(anno, spec, now)
    hot_value = get_node_hot_value(anno, now)
    score = score - go_trunc(hot_value * 10)
    # Go ints are 64-bit two's complement; the subtraction above can wrap
    # when the degenerate zero-weight-sum path yields int64-min.
    score = ((score + 2**63) % 2**64) - 2**63
    return normalize_score(score, MAX_NODE_SCORE, MIN_NODE_SCORE)
