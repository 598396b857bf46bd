"""Go-compatible duration parsing.

Copy of ``crane_scheduler_tpu/utils/duration.py``.

Policy files express sync periods and hot-value windows as Go duration
strings ("3m", "15m", "3h", "1.5h", "2h45m"); the reference decodes them with
``metav1.Duration`` / ``time.ParseDuration``. This module reproduces that
grammar so the same YAML policy documents decode identically
(ref: pkg/plugins/apis/policy/v1alpha1/types.go:14-39).
"""

from __future__ import annotations

_UNITS = {
    "ns": 1e-9,
    "us": 1e-6,
    "µs": 1e-6,
    "μs": 1e-6,
    "ms": 1e-3,
    "s": 1.0,
    "m": 60.0,
    "h": 3600.0,
}


class DurationError(ValueError):
    pass


def parse_go_duration(s: str) -> float:
    """Parse a Go duration string into seconds (float).

    Grammar per Go ``time.ParseDuration``: an optionally-signed sequence of
    decimal numbers each with optional fraction and a mandatory unit suffix,
    e.g. "300ms", "-1.5h", "2h45m". "0" (bare zero) is allowed.
    """
    if not isinstance(s, str):
        raise DurationError(f"duration must be a string, got {type(s)!r}")
    orig = s
    neg = False
    if s and s[0] in "+-":
        neg = s[0] == "-"
        s = s[1:]
    if s == "0":
        return 0.0
    if not s:
        raise DurationError(f"invalid duration {orig!r}")
    total = 0.0
    i = 0
    n = len(s)
    while i < n:
        start = i
        while i < n and (s[i].isdigit() or s[i] == "."):
            i += 1
        num = s[start:i]
        if not num or num == "." or num.count(".") > 1:
            raise DurationError(f"invalid duration {orig!r}")
        # unit: longest match first
        unit = None
        for u in ("ns", "us", "µs", "μs", "ms", "h", "m", "s"):
            if s.startswith(u, i):
                # bare "m" must not swallow the "m" of "ms"
                unit = u
                break
        if unit is None:
            raise DurationError(f"missing unit in duration {orig!r}")
        i += len(unit)
        total += float(num) * _UNITS[unit]
    return -total if neg else total


def format_go_duration(seconds: float) -> str:
    """Render seconds as a Go-style duration string (h/m/s granularity)."""
    if seconds == 0:
        return "0s"
    neg = seconds < 0
    seconds = abs(seconds)
    parts = []
    h = int(seconds // 3600)
    m = int((seconds % 3600) // 60)
    sec = seconds - h * 3600 - m * 60
    if h:
        parts.append(f"{h}h")
    if m:
        parts.append(f"{m}m")
    if sec:
        if sec == int(sec):
            parts.append(f"{int(sec)}s")
        else:
            parts.append(f"{sec}s")
    return ("-" if neg else "") + "".join(parts)
