"""Timestamp codec reproducing the reference's timezone quirk.

Copy of ``crane_scheduler_tpu/utils/timeutil.py``.

The reference renders annotation timestamps with Go layout
``2006-01-02T15:04:05Z`` **in local time** (env ``TZ``, default
``Asia/Shanghai``): the trailing ``Z`` is a literal character, not a UTC
marker (ref: pkg/utils/utils.go:10-45). The reader parses with
``time.ParseInLocation`` using the same location
(ref: pkg/plugins/dynamic/stats.go:36), so values round-trip — but only if
writer and reader agree on the zone. We reproduce this exactly: wire strings
look like UTC but are local, and we store epoch seconds internally.
"""

from __future__ import annotations

import functools
import os
import time as _time
from datetime import datetime, timezone
from zoneinfo import ZoneInfo

# Go layout "2006-01-02T15:04:05Z" with literal Z, rendered in local TZ.
TIME_FORMAT = "%Y-%m-%dT%H:%M:%SZ"
DEFAULT_TIMEZONE = "Asia/Shanghai"  # ref: pkg/utils/utils.go:12
# Timestamps shorter than this are rejected outright
# (ref: pkg/plugins/dynamic/stats.go:19-20,31-34).
MIN_TIMESTAMP_STR_LENGTH = 5


def _zone_for(zone_name: str) -> ZoneInfo:
    try:
        return ZoneInfo(zone_name)
    except Exception:
        return ZoneInfo(DEFAULT_TIMEZONE)


def get_location() -> ZoneInfo:
    """Resolve the annotation timezone from env ``TZ`` (ref: utils.go:36-45).

    Env is re-read on every call (tests flip ``TZ``); ZoneInfo itself
    caches per zone name, so this is a dict lookup in the steady state.
    """
    return _zone_for(os.environ.get("TZ") or DEFAULT_TIMEZONE)


def now_epoch() -> float:
    return _time.time()


@functools.lru_cache(maxsize=4096)
def _format_cached(whole_seconds: int, zone_key: str) -> str:
    # the zone must derive from the cache KEY, not a second env read — a
    # concurrent TZ flip between the caller's read and this body would
    # otherwise poison the cache under the wrong key
    dt = datetime.fromtimestamp(whole_seconds, tz=timezone.utc).astimezone(
        _zone_for(zone_key)
    )
    return dt.strftime(TIME_FORMAT)


def format_local_time(epoch_seconds: float | None = None) -> str:
    """Epoch seconds -> quirky local-time-with-literal-Z wire string.

    Cached per (whole second, zone): the wire format has second
    precision, and an annotator sync formats the same ``now`` for every
    node x metric — strftime dominated bulk-sync profiles before this.
    The sub-second remainder cannot change the output (strftime has no
    sub-second field in this layout), so truncating the cache key is
    exact.
    """
    if epoch_seconds is None:
        epoch_seconds = _time.time()
    zone_key = os.environ.get("TZ") or DEFAULT_TIMEZONE
    # int() truncates toward zero; fromtimestamp floors — keep exactness
    # for negative epochs by flooring explicitly
    whole = int(epoch_seconds // 1)
    return _format_cached(whole, zone_key)


@functools.lru_cache(maxsize=4096)
def _parse_cached(s: str, zone_key: str) -> float | None:
    try:
        naive = datetime.strptime(s, TIME_FORMAT)
    except ValueError:
        return None
    local = naive.replace(tzinfo=_zone_for(zone_key))  # key-derived zone
    return local.timestamp()


def parse_local_time(s: str) -> float | None:
    """Wire string -> epoch seconds, or None if invalid.

    Mirrors ``inActivePeriod``'s validity checks: too-short strings and
    layout mismatches are rejected (ref: stats.go:30-41). The string is
    interpreted in the configured location, matching
    ``time.ParseInLocation``. Cached per (string, zone): annotation
    sweeps parse the same handful of sync timestamps tens of thousands
    of times, and strptime dominated those profiles.
    """
    if not isinstance(s, str) or len(s) < MIN_TIMESTAMP_STR_LENGTH:
        return None
    return _parse_cached(s, os.environ.get("TZ") or DEFAULT_TIMEZONE)
