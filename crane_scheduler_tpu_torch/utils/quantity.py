"""Kubernetes resource-quantity parsing (the subset schedulers need).

Copy of ``crane_scheduler_tpu/utils/quantity.py``.

Supports the k8s canonical forms: plain/decimal numbers ("2", "0.5"),
milli-suffix ("500m"), binary suffixes (Ki Mi Gi Ti Pi Ei) and decimal
suffixes (k M G T P E), and scientific notation ("1e3"). Values convert to
integer base units the way the reference's ``framework.Resource`` does:
CPU to millicores (rounded up), everything else to whole units
(bytes for memory), matching ``resource.Quantity.MilliValue``/``Value``.
"""

from __future__ import annotations

import functools
import math

_BINARY = {"Ki": 1024, "Mi": 1024**2, "Gi": 1024**3, "Ti": 1024**4, "Pi": 1024**5, "Ei": 1024**6}
_DECIMAL = {"k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15, "E": 10**18}


class QuantityError(ValueError):
    pass


def parse_quantity(value) -> float:
    """Parse a quantity into a float of base units.

    Pure, so string parses memoize: a cluster sweep parses the same few
    quantity literals ("64000m", "256Gi", ...) per node per zone, and
    the suffix scan dominated NUMA wrapper-build profiles.
    """
    if isinstance(value, bool):
        raise QuantityError(f"invalid quantity {value!r}")
    if isinstance(value, (int, float)):
        return float(value)
    if not isinstance(value, str) or not value:
        raise QuantityError(f"invalid quantity {value!r}")
    return _parse_str(value)


@functools.lru_cache(maxsize=65536)
def _parse_str(value: str) -> float:
    s = value.strip()
    for suffix, mult in _BINARY.items():
        if s.endswith(suffix):
            return _number(s[: -len(suffix)]) * mult
    if s.endswith("m"):
        return _number(s[:-1]) / 1000.0
    for suffix, mult in _DECIMAL.items():
        if s.endswith(suffix):
            return _number(s[: -len(suffix)]) * mult
    return _number(s)


def _number(s: str) -> float:
    try:
        return float(s)
    except ValueError as e:
        raise QuantityError(f"invalid quantity number {s!r}") from e


def to_milli(value) -> int:
    """Quantity -> integer milli-units, rounding up like
    ``resource.Quantity.MilliValue`` (ceil for fractional nanos)."""
    return int(math.ceil(parse_quantity(value) * 1000 - 1e-9))


def to_value(value) -> int:
    """Quantity -> integer whole units, rounding up like
    ``resource.Quantity.Value``."""
    return int(math.ceil(parse_quantity(value) - 1e-9))
