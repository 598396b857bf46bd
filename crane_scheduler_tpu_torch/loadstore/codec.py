"""Annotation wire codec: ``"<float>,<localtime>"``.

Copy of ``crane_scheduler_tpu/loadstore/codec.py``.

The data-plane contract between the annotator and the scorer is a node
annotation map ``metricName -> "floatValue,timestamp"``
(written at ref: pkg/controller/annotator/node.go:123-146, parsed at
ref: pkg/plugins/dynamic/stats.go:51-76). This module reproduces both ends:

- encode: value rendered by the metrics source (5-decimal fixed for
  Prometheus, ref: pkg/controller/prometheus/prometheus.go:124) or a bare
  integer for hot values (ref: node.go:113-121), joined with the quirky
  local-time timestamp.
- decode: split on "," requiring exactly two parts; timestamp parsed
  separately from value so staleness can be evaluated at read time with a
  caller-supplied ``now``.
"""

from __future__ import annotations

import math
import re

import numpy as np

from ..utils.timeutil import format_local_time, parse_local_time

# Go 1.13+ numeric literal syntax: underscores may appear between digits
# of any group ("1_000.5", "1e1_0"); hex floats need a mandatory p-exponent.
_D = r"\d(?:_?\d)*"
_H = r"[0-9a-fA-F](?:_?[0-9a-fA-F])*"
_GO_FLOAT_RE = re.compile(
    rf"^[+-]?(?:{_D}(?:\.(?:{_D})?)?|\.{_D})(?:[eE][+-]?{_D})?$"
)
_GO_HEX_RE = re.compile(rf"^[+-]?0[xX](?:{_H}(?:\.(?:{_H})?)?|\.{_H})[pP][+-]?{_D}$")
_GO_SPECIAL_RE = re.compile(r"^[+-]?(inf(inity)?|nan)$", re.IGNORECASE)


def go_parse_float(s: str) -> float | None:
    """``strconv.ParseFloat(s, 64)`` equivalent; None on parse failure.

    Accepts decimal/exponent forms (with Go 1.13 underscore grouping),
    hex floats with p-exponent, and inf/infinity/nan (any case, optional
    sign). Rejects leading/trailing whitespace and malformed underscores,
    as Go does.
    """
    if not isinstance(s, str):
        return None
    # fast path: plain ASCII unsigned decimal (the Prometheus 5-decimal
    # rendering, by far the common case) — digits with at most one dot
    # is accepted identically by Go and float(); everything else (signs,
    # exponents, underscores, unicode digits, whitespace) falls through
    # to the exact-semantics matchers
    if s.isascii() and s.replace(".", "", 1).isdigit():
        return float(s)
    if _GO_FLOAT_RE.match(s):
        return float(s.replace("_", ""))
    if _GO_HEX_RE.match(s):
        return float.fromhex(s.replace("_", ""))
    if _GO_SPECIAL_RE.match(s):
        return float(s)
    return None


def format_metric_value(value: float) -> str:
    """Prometheus-side value serialization: 5-decimal fixed notation
    (ref: prometheus.go:124 ``strconv.FormatFloat(v, 'f', 5, 64)``)."""
    if math.isnan(value):
        return "NaN"
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    return f"{value:.5f}"


def encode_annotation(value_str: str, epoch_seconds: float | None = None) -> str:
    """``value + "," + localTime`` (ref: node.go:142)."""
    return f"{value_str},{format_local_time(epoch_seconds)}"


def decode_annotation(raw: str) -> tuple[float | None, float | None]:
    """Decode to ``(value, ts_epoch)``; either part is None if invalid.

    Mirrors ``getResourceUsage``'s structural checks
    (ref: stats.go:51-76): the string must split on "," into exactly two
    parts; the timestamp must parse under the local-TZ layout; the value
    must parse as a float. Semantic checks (staleness, negativity) are the
    reader's job — this function only decodes.
    """
    if not isinstance(raw, str):
        return None, None
    parts = raw.split(",")
    if len(parts) != 2:
        return None, None
    value = go_parse_float(parts[0])
    ts = parse_local_time(parts[1])
    return value, ts


def decode_annotation_or_missing(raw: str) -> tuple[float, float]:
    """Decode with the store's fail-open sentinel: a structurally invalid
    annotation becomes ``(nan, -inf)`` — never fresh, so every reader
    takes the fail-open path exactly like a parse error
    (ref: stats.go:96-99). The single source of the missing-value
    sentinels for both the re-ingest and direct-write paths."""
    value, ts = decode_annotation(raw)
    if value is None or ts is None:
        return float("nan"), float("-inf")
    return value, ts


# -- batch decode -----------------------------------------------------------
#
# ``bulk_decode_annotations`` is the pure-numpy twin of the native bulk
# parser (native/crane_native.cpp crane_parse_annotations): it decodes a
# whole column of wire strings in a handful of vectorized passes over one
# concatenated byte buffer, element-for-element identical to
# ``decode_annotation_or_missing``. The store's bulk ingest used to call
# the per-string decoder |nodes| x |metrics| times per refresh when the
# native library was unavailable; that Python loop dominated 50k-node
# cold refreshes.

_COMMA = 0x2C
_DOT = 0x2E
_ZERO = 0x30
_NINE = 0x39
_TS_LEN = 20  # canonical "YYYY-MM-DDTHH:MM:SSZ"
# 10^k exactly representable in int64/f64 for k <= 15: a plain decimal
# with <= 15 digits is (digits / 10^frac) with BOTH operands exact, so
# one IEEE division yields the correctly-rounded value — bit-identical
# to float(s) and Go's strconv.ParseFloat.
_MAX_FAST_DIGITS = 15
_POW10_F64 = np.power(
    10, np.arange(_MAX_FAST_DIGITS + 1), dtype=np.int64
).astype(np.float64)


def _bulk_decode_fallback(strs, values: np.ndarray, ts_out: np.ndarray) -> None:
    for i, s in enumerate(strs):
        if not s:
            continue
        v, t = decode_annotation(s)
        if v is None or t is None:
            continue
        values[i], ts_out[i] = v, t


def bulk_decode_annotations(raws) -> tuple[np.ndarray, np.ndarray]:
    """Decode a batch of ``"value,timestamp"`` strings (entries may be
    ``None``) into ``(values[n], ts[n])`` float64 arrays with the
    fail-open encoding: structurally invalid -> ``(nan, -inf)``; a value
    that parsed to NaN keeps its real timestamp.

    Bit-for-bit identical to ``decode_annotation_or_missing`` per entry:
    timestamps are parsed by ``parse_local_time`` itself (once per
    DISTINCT 20-byte timestamp — an annotator sweep repeats a handful of
    sync times across the whole cluster), and values take a vectorized
    exact-division fast path for plain unsigned decimals (<= 15 digits),
    falling back to ``go_parse_float`` per entry for everything else
    (signs, exponents, specials, over-long digit runs).
    """
    n = len(raws)
    values = np.full((n,), np.nan, dtype=np.float64)
    ts_out = np.full((n,), -np.inf, dtype=np.float64)
    if n == 0:
        return values, ts_out
    strs = [r if isinstance(r, str) else "" for r in raws]
    joined = "".join(strs)
    buffer = joined.encode("utf-8", "replace")
    if len(buffer) != len(joined):
        # non-ASCII input: byte offsets diverge from char offsets — rare
        # (never produced by our encoder); decode per entry, exactly
        _bulk_decode_fallback(strs, values, ts_out)
        return values, ts_out
    b = np.frombuffer(buffer, dtype=np.uint8)
    lens = np.fromiter(map(len, strs), dtype=np.int64, count=n)
    offsets = np.zeros((n + 1,), dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    starts, ends = offsets[:-1], offsets[1:]

    # structural gate: the split on "," must yield exactly two parts
    commas = np.flatnonzero(b == _COMMA)
    if not commas.size:
        return values, ts_out
    owner = np.searchsorted(offsets, commas, side="right") - 1
    ccount = np.bincount(owner, minlength=n)[:n]
    ok = ccount == 1
    if not ok.any():
        return values, ts_out
    cpos = np.zeros((n,), dtype=np.int64)
    cpos[owner] = commas  # multi-comma rows are excluded by ``ok``

    # timestamp part. Canonical 20-byte stamps ("YYYY-MM-DDTHH:MM:SSZ")
    # are keyed by their 14 digits packed into one int64 (the punctuation
    # positions are fixed, so equal key + valid punctuation == identical
    # bytes); each DISTINCT stamp is parsed once by the exact per-string
    # parser (zone rules, strptime validity and all) and broadcast back.
    # An annotator sweep repeats a handful of sync times cluster-wide, so
    # this is O(distinct) Python work. A 20-char string failing the
    # digit/punctuation layout cannot parse under the strptime format
    # (every field is at its maximum width exactly when the total length
    # is 20), so those are -inf with no fallback needed; non-20 lengths
    # (exotic short-field strptime forms) parse per entry.
    tstart = cpos + 1
    tlen = ends - tstart
    canon = np.flatnonzero(ok & (tlen == _TS_LEN))
    if canon.size:
        cstart = tstart[canon]

        def at(j):
            return b[cstart + j]

        punct_ok = (
            (at(4) == 0x2D) & (at(7) == 0x2D) & (at(10) == 0x54)
            & (at(13) == 0x3A) & (at(16) == 0x3A) & (at(19) == 0x5A)
        )
        key = np.zeros(canon.size, dtype=np.int64)
        digits_ok = punct_ok
        for j in (0, 1, 2, 3, 5, 6, 8, 9, 11, 12, 14, 15, 17, 18):
            byte = at(j)
            digits_ok = digits_ok & (byte >= _ZERO) & (byte <= _NINE)
            key = key * 10 + (byte - _ZERO)
        kidx = np.flatnonzero(digits_ok)
        if kidx.size:
            uniq, first, inverse = np.unique(
                key[kidx], return_index=True, return_inverse=True
            )
            uts = np.empty((uniq.size,), dtype=np.float64)
            for j in range(uniq.size):
                s0 = int(cstart[kidx[first[j]]])
                t = parse_local_time(joined[s0:s0 + _TS_LEN])
                uts[j] = -np.inf if t is None else t
            ts_out[canon[kidx]] = uts[inverse]
    for i in np.flatnonzero(ok & (tlen != _TS_LEN)):
        t = parse_local_time(joined[tstart[i]:ends[i]])
        if t is not None:
            ts_out[i] = t
    tsok = ok & ~np.isneginf(ts_out)
    if not tsok.any():
        return values, ts_out

    # value part fast path: unsigned plain decimals, parsed by exact
    # left-to-right integer accumulation + one division (see
    # _MAX_FAST_DIGITS). One [k] gather per character position (value
    # strings are short); everything else (signs, exponents, specials,
    # over-long digit runs) falls back to the exact per-string parser.
    vlen = cpos - starts
    cand = np.flatnonzero(tsok & (vlen > 0) & (vlen <= _MAX_FAST_DIGITS + 1))
    fast_ok = np.zeros((n,), dtype=bool)
    if cand.size:
        cs, ce = starts[cand], cpos[cand]
        width = int(vlen[cand].max())
        num = np.zeros(cand.size, dtype=np.int64)
        ndig = np.zeros(cand.size, dtype=np.int64)
        ndot = np.zeros(cand.size, dtype=np.int64)
        frac = np.zeros(cand.size, dtype=np.int64)
        seen_dot = np.zeros(cand.size, dtype=bool)
        for j in range(width):
            pos = cs + j
            inreg = pos < ce
            byte = b[np.minimum(pos, b.size - 1)]
            isd = inreg & (byte >= _ZERO) & (byte <= _NINE)
            isp = inreg & (byte == _DOT)
            num = np.where(isd, num * 10 + (byte - _ZERO), num)
            ndig += isd
            ndot += isp
            seen_dot |= isp
            frac += isd & seen_dot
        good = (
            (ndig >= 1) & (ndig <= _MAX_FAST_DIGITS) & (ndot <= 1)
            & (ndig + ndot == vlen[cand])
        )
        gidx = cand[good]
        values[gidx] = num[good].astype(np.float64) / _POW10_F64[frac[good]]
        fast_ok[gidx] = True
    for i in np.flatnonzero(tsok & ~fast_ok):
        v = go_parse_float(joined[starts[i]:cpos[i]])
        if v is None:
            ts_out[i] = -np.inf  # unparseable value == structurally invalid
        else:
            values[i] = v
    return values, ts_out
