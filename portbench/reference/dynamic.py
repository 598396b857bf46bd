"""The Dynamic plugin's Filter and Score over every node, in NumPy.

Semantics of crane-scheduler's ``pkg/plugins/dynamic`` (stats.go,
plugins.go), for annotations that all parse:

- a usage entry is valid when ``now < ts + period + 300 s`` and the value
  is not negative; an invalid entry neither overloads nor scores;
- Filter: a node is overloaded when a valid predicate entry with a nonzero
  threshold reads above it;
- Score: ``trunc(sum_k fl(fl((1 - u_k) * w_k) * 100) / sum_k w_k)`` in
  policy order, minus ``trunc(hot * 10)`` for a hot value younger than
  300 s, clamped to [0, 100].

``dtype`` is float64, the plugin's own precision; float32 is the control
that computes the same in the precision below.
"""

from __future__ import annotations

import re

import numpy as np

EXTRA_ACTIVE_S = 300.0  # added to every sync period (stats.go)
HOT_ACTIVE_S = 300.0  # the hot value's fixed window (stats.go)
_UNITS = {"h": 3600.0, "m": 60.0, "s": 1.0}


def duration_s(text: str) -> float:
    """A Go duration such as ``3m``, ``1h30m`` or ``45s`` in seconds."""
    parts = re.findall(r"(\d+(?:\.\d+)?)([hms])", text)
    if not parts or "".join(a + b for a, b in parts) != text:
        raise ValueError(f"unsupported duration {text!r}")
    return sum(float(a) * _UNITS[b] for a, b in parts)


def policy_entries(spec: dict) -> tuple[list, list]:
    """(predicates, priorities) of a policy ``spec``: ``(metric, threshold
    or weight, active seconds)`` in policy order."""
    period = {}
    for sp in spec.get("syncPolicy", []):
        secs = duration_s(sp["period"])
        if secs != 0 and sp["name"] not in period:
            period[sp["name"]] = secs + EXTRA_ACTIVE_S
    preds = [(p["name"], float(p["maxLimitPecent"]), period.get(p["name"], 0.0))
             for p in spec.get("predicate", [])]
    prios = [(p["name"], float(p["weight"]), period.get(p["name"], 0.0))
             for p in spec.get("priority", [])]
    return preds, prios


def filter_score(spec: dict, metrics: list, values, ts, hot, hot_ts, now: float,
                 dtype=np.float64) -> tuple[np.ndarray, np.ndarray]:
    """Filter verdicts (bool [N]) and scores (int64 [N]) of every node.

    ``values``/``ts`` are [N, M] over ``metrics`` (parsed annotation values
    and epoch seconds), ``hot``/``hot_ts`` [N]."""
    preds, prios = policy_entries(spec)
    col = {m: k for k, m in enumerate(metrics)}
    f = np.dtype(dtype).type
    values = np.asarray(values, dtype=np.float64)
    ts = np.asarray(ts, dtype=np.float64)
    n = values.shape[0]
    # timestamps compare in float64 (whole epoch seconds); only the usage
    # arithmetic runs in ``dtype``
    over = np.zeros(n, dtype=bool)
    for name, threshold, active in preds:
        if active == 0 or threshold == 0:
            continue
        u = values[:, col[name]].astype(dtype)
        valid = (now < ts[:, col[name]] + active) & ~(u < 0)
        over |= valid & (u > f(threshold))
    acc = np.zeros(n, dtype=dtype)
    weight = f(0.0)
    for name, w, active in prios:
        weight = f(weight + f(w))
        if active == 0:
            continue
        u = values[:, col[name]].astype(dtype)
        valid = (now < ts[:, col[name]] + active) & ~(u < 0)
        term = (f(1.0) - u) * f(w)
        term = term * f(100.0)
        acc = acc + np.where(valid, term, f(0.0))
    with np.errstate(divide="ignore", invalid="ignore"):
        base = _go_int(acc / weight) if prios else np.zeros(n, np.int64)
    hot = np.asarray(hot, dtype=np.float64).astype(dtype)
    hot_ok = (now < np.asarray(hot_ts, np.float64) + HOT_ACTIVE_S) & ~(hot < 0)
    penalty = _go_int(np.where(hot_ok, hot, f(0.0)) * f(10.0))
    score = np.clip(base - penalty, 0, 100).astype(np.int64)
    return ~over, score


def _go_int(x) -> np.ndarray:
    """Go ``int(float64)``: truncation toward zero; NaN, +-Inf and values
    out of range give the int64 minimum."""
    x = np.asarray(x, dtype=np.float64)
    ok = np.isfinite(x) & (np.abs(x) < 2.0 ** 63)
    return np.where(ok, np.trunc(np.where(ok, x, 0.0)), 0).astype(np.int64) + \
        np.where(ok, 0, np.iinfo(np.int64).min).astype(np.int64)
