"""Score arithmetic helpers matching Go integer semantics.

Copy of ``crane_scheduler_tpu/utils/score.py``.
"""

from __future__ import annotations

import math

_GO_MIN_INT64 = -(2**63)


def go_trunc(x: float) -> int:
    """Go ``int(floatExpr)``: truncation toward zero.

    Non-finite and out-of-int64-range inputs are mapped to Go/amd64's
    "integer indefinite" (min int64) — the observable behavior of
    ``CVTTSD2SI`` for NaN/±Inf/overflow — so downstream clamping matches
    the reference on degenerate paths (ref: pkg/plugins/dynamic/stats.go:135).
    """
    if math.isnan(x) or math.isinf(x):
        return _GO_MIN_INT64
    t = math.trunc(x)
    if t < _GO_MIN_INT64 or t >= 2**63:
        return _GO_MIN_INT64
    return t


def normalize_score(value: int, max_score: int = 100, min_score: int = 0) -> int:
    """Clamp to [min, max] (ref: pkg/utils/utils.go:58-68)."""
    if value < min_score:
        return min_score
    if value > max_score:
        return max_score
    return value
