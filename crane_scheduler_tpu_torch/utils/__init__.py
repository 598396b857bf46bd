from .duration import parse_go_duration, format_go_duration
from .timeutil import (
    TIME_FORMAT,
    DEFAULT_TIMEZONE,
    MIN_TIMESTAMP_STR_LENGTH,
    get_location,
    format_local_time,
    parse_local_time,
    now_epoch,
)
from .score import normalize_score, go_trunc
from .system import (
    DEFAULT_SYSTEM_NAMESPACE,
    SYSTEM_NAMESPACE_ENV,
    system_namespace,
)
from .logging import set_verbosity, verbosity, vlog

__all__ = [
    "set_verbosity",
    "verbosity",
    "vlog",
    "DEFAULT_SYSTEM_NAMESPACE",
    "SYSTEM_NAMESPACE_ENV",
    "system_namespace",
    "parse_go_duration",
    "format_go_duration",
    "TIME_FORMAT",
    "DEFAULT_TIMEZONE",
    "MIN_TIMESTAMP_STR_LENGTH",
    "get_location",
    "format_local_time",
    "parse_local_time",
    "now_epoch",
    "normalize_score",
    "go_trunc",
]
