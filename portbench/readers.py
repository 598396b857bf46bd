"""What the per-layer readers under ``metrics/`` share. Each reader takes
the run's observations: ``call_s`` (wall seconds of each timed entry
call, untraced), ``profile`` (the profiled stretch's summary from
``trace.py``), ``profiled_calls`` and what the driver observes (its
shapes; the drip driver's ``batch``: the untraced window's deltas of the
scheduler's batch counters and stage seconds); it returns a number, or
None when the run holds nothing for it to read."""

from __future__ import annotations

import statistics


def quantile_ms(obs: dict, q: float):
    calls = obs.get("call_s") or []
    if len(calls) < 2:
        return None
    if q == 0.5:
        return statistics.median(calls) * 1e3
    return statistics.quantiles(calls, n=100)[int(q * 100) - 1] * 1e3


def per_call(obs: dict, key: str):
    p = obs.get("profile")
    if not p or not obs.get("profiled_calls"):
        return None
    return p[key] / obs["profiled_calls"]


def mean_call_s(obs: dict):
    calls = obs.get("call_s") or []
    return sum(calls) / len(calls) if calls else None


def per_window(obs: dict, value: float):
    """``value`` per window the scheduler dispatched in the untraced
    window."""
    windows = (obs.get("batch") or {}).get("dispatches")
    return value / windows if windows else None


def stage_ms(obs: dict, stage: str):
    """Ms of the port's drip stage clock (``DRIP_STAGES``) per dispatched
    window, over the untraced window."""
    seconds = (obs.get("batch") or {}).get("stage_seconds", {}).get(stage)
    return None if seconds is None else per_window(obs, 1e3 * seconds)
