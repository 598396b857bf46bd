"""Bulk annotation codec through the host library.

Copy of ``crane_scheduler_tpu/native/codec.py``. One C call parses a batch
of ``"value,timestamp"`` wire strings (``bulk_parse_annotations``), a batch
of bare metric values with Go ``ParseFloat`` semantics
(``bulk_parse_values``), or renders a float column with the Prometheus
5-decimal contract (``bulk_render_f5``). The C timestamp parser knows only a
fixed UTC offset: a zone with DST takes the numpy twin
``bulk_decode_annotations``, which parses through the exact per-string
codec, as the reference does. Render rows longer than 31 characters come
back empty from C and are re-rendered by ``format_metric_value``.
"""

from __future__ import annotations

import ctypes
from datetime import datetime, timedelta

import numpy as np

from ..loadstore.codec import bulk_decode_annotations, format_metric_value, go_parse_float
from ..utils.timeutil import get_location
from .lib import load_native

_NEG_INF = float("-inf")
_P_I64 = ctypes.POINTER(ctypes.c_int64)
_P_F64 = ctypes.POINTER(ctypes.c_double)
_P_U8 = ctypes.POINTER(ctypes.c_uint8)


def _fixed_utc_offset_seconds() -> int | None:
    """The zone's UTC offset if it is DST-free (sampled across a year)."""
    loc = get_location()
    offsets = set()
    for month in (1, 4, 7, 10):
        dt = datetime(2025, month, 15, tzinfo=loc)
        offsets.add(dt.utcoffset() or timedelta(0))
    if len(offsets) != 1:
        return None
    return int(offsets.pop().total_seconds())


def _joined(strs: list) -> tuple[bytes, np.ndarray]:
    """One UTF-8 buffer and its n+1 byte offsets: one join and one encode
    when every string is ASCII (char offsets == byte offsets; a length
    mismatch detects any non-ASCII batch exactly)."""
    n = len(strs)
    joined = "".join(strs)
    buffer = joined.encode("utf-8", "replace")
    offsets = np.zeros((n + 1,), dtype=np.int64)
    if len(buffer) == len(joined):
        np.cumsum(np.fromiter(map(len, strs), np.int64, count=n), out=offsets[1:])
    else:
        encoded = [s.encode("utf-8", "replace") for s in strs]
        np.cumsum([len(b) for b in encoded], out=offsets[1:])
        buffer = b"".join(encoded)
    return buffer, offsets


def bulk_parse_annotations(raw_strings) -> tuple[np.ndarray, np.ndarray]:
    """[(str|None)] -> (values[n], ts[n]) float64; missing/invalid entries
    get ts=-inf (fail-open), matching ``decode_annotation_or_missing``."""
    offset = _fixed_utc_offset_seconds()
    if offset is None:
        # a zone with DST: the numpy twin parses through the exact
        # per-string timestamp codec
        return bulk_decode_annotations(raw_strings)
    lib = load_native()
    n = len(raw_strings)
    values = np.full((n,), np.nan, dtype=np.float64)
    ts = np.full((n,), _NEG_INF, dtype=np.float64)
    buffer, offsets = _joined([s if isinstance(s, str) else "" for s in raw_strings])
    lib.crane_parse_annotations(
        buffer, offsets.ctypes.data_as(_P_I64), n, offset,
        values.ctypes.data_as(_P_F64), ts.ctypes.data_as(_P_F64),
    )
    return values, ts


def bulk_parse_values(strings) -> tuple[np.ndarray, np.ndarray]:
    """Parse bare metric-value strings with Go ``ParseFloat`` semantics in
    one C call: ``(values[n] float64, ok[n] bool)``; unparseable entries
    are (NaN, False)."""
    lib = load_native()
    n = len(strings)
    values = np.empty((n,), dtype=np.float64)
    ok = np.empty((n,), dtype=np.uint8)
    if n == 0:
        return values, ok.astype(bool)
    buffer, offsets = _joined(list(strings))
    lib.crane_parse_values(
        buffer, offsets.ctypes.data_as(_P_I64), n,
        values.ctypes.data_as(_P_F64), ok.ctypes.data_as(_P_U8),
    )
    return values, ok.astype(bool)


def bulk_render_f5(vals: np.ndarray, with_parse: bool = False):
    """Render a float column with the Prometheus 5-decimal contract
    (``format_metric_value``) in one C call; returns the string list.
    Callers apply the negative/NaN clamp first.

    ``with_parse=True`` returns ``(strings, parsed, ok)`` where ``parsed``
    is the Go parse of the rendered strings, computed from the same
    buffer: exactly the values a re-ingest of the strings would give."""
    lib = load_native()
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    n = len(vals)
    buf = ctypes.create_string_buffer(n * 32)
    offsets = np.empty((n + 1,), dtype=np.int64)
    lib.crane_render_f5(vals.ctypes.data_as(_P_F64), n, buf, offsets.ctypes.data_as(_P_I64))
    text = buf.raw[: offsets[n]].decode("ascii")
    off = offsets.tolist()
    out = [text[off[i]:off[i + 1]] for i in range(n)]
    # rows over 31 characters (|v| >= ~1e25) come back empty
    oversize_rows = [i for i, s in enumerate(out) if not s]
    for i in oversize_rows:
        out[i] = format_metric_value(float(vals[i]))
    if not with_parse:
        return out
    parsed = np.empty((n,), dtype=np.float64)
    ok = np.empty((n,), dtype=np.uint8)
    if n:
        lib.crane_parse_values(buf, offsets.ctypes.data_as(_P_I64), n,
                               parsed.ctypes.data_as(_P_F64), ok.ctypes.data_as(_P_U8))
        # the buffer holds an empty slice for an oversize row: parse its
        # Python rendering so parsed == parse(out) exactly
        for i in oversize_rows:
            v = go_parse_float(out[i])
            parsed[i] = float("nan") if v is None else v
            ok[i] = v is not None
    return out, parsed, ok.astype(bool)
