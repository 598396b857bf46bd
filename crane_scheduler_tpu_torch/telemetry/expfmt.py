"""Strict Prometheus text-exposition (0.0.4) parser.

Copy of ``crane_scheduler_tpu/telemetry/expfmt.py``.

Used by the tests and ``chip_smoke.py`` to validate ``render()``:
a ``/metrics`` payload that any real scraper could choke on must fail
CI, not page an operator later. Deliberately stricter than Prometheus'
own lenient parser:

- every line must be a comment, blank, or well-formed sample;
- ``# TYPE`` must precede the family's samples and appear at most once;
- sample names must belong to a declared family (histograms own their
  ``_bucket``/``_sum``/``_count`` suffixes);
- duplicate series (same name + label set) are rejected;
- histogram buckets must be cumulative, carry parseable ``le`` bounds in
  increasing order, and end with ``le="+Inf"`` equal to ``_count``;
- counter values must be finite and non-negative;
- the payload must end with a newline.
"""

from __future__ import annotations

import math
import re

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_TYPES = ("counter", "gauge", "histogram", "summary", "untyped")


class ExpositionError(ValueError):
    """A strict-format violation, with the offending line number."""

    def __init__(self, lineno: int, message: str):
        super().__init__(f"line {lineno}: {message}")
        self.lineno = lineno


def _parse_value(lineno: int, raw: str) -> float:
    if raw in ("+Inf", "Inf"):
        return math.inf
    if raw == "-Inf":
        return -math.inf
    if raw == "NaN":
        return math.nan
    try:
        return float(raw)
    except ValueError:
        raise ExpositionError(lineno, f"unparseable value {raw!r}") from None


def _parse_labels(lineno: int, raw: str) -> tuple[tuple[str, str], ...]:
    """Parse the inside of a ``{...}`` label block with escape handling."""
    labels: list[tuple[str, str]] = []
    i, n = 0, len(raw)
    while i < n:
        j = i
        while j < n and raw[j] not in "=":
            j += 1
        if j >= n:
            raise ExpositionError(lineno, f"label without '=': {raw[i:]!r}")
        name = raw[i:j].strip()
        if not _LABEL_RE.match(name):
            raise ExpositionError(lineno, f"invalid label name {name!r}")
        i = j + 1
        if i >= n or raw[i] != '"':
            raise ExpositionError(lineno, f"label {name!r} value not quoted")
        i += 1
        out: list[str] = []
        while True:
            if i >= n:
                raise ExpositionError(lineno, f"unterminated value for {name!r}")
            ch = raw[i]
            if ch == "\\":
                if i + 1 >= n:
                    raise ExpositionError(lineno, "dangling escape")
                nxt = raw[i + 1]
                if nxt == "n":
                    out.append("\n")
                elif nxt in ("\\", '"'):
                    out.append(nxt)
                else:
                    raise ExpositionError(lineno, f"bad escape \\{nxt}")
                i += 2
            elif ch == '"':
                i += 1
                break
            else:
                out.append(ch)
                i += 1
        labels.append((name, "".join(out)))
        if i < n:
            if raw[i] != ",":
                raise ExpositionError(
                    lineno, f"expected ',' between labels, got {raw[i]!r}"
                )
            i += 1
    return tuple(labels)


def _label_block_end(lineno: int, raw: str) -> int:
    """Index of the ``}`` closing the label block ``raw`` starts with,
    honoring quoted values and escapes — ``rfind`` would grab a brace
    from an exemplar tail (or a quoted value) further right."""
    in_quote = False
    i, n = 1, len(raw)
    while i < n:
        ch = raw[i]
        if in_quote:
            if ch == "\\":
                i += 1
            elif ch == '"':
                in_quote = False
        elif ch == '"':
            in_quote = True
        elif ch == "}":
            return i
        i += 1
    raise ExpositionError(lineno, "unterminated label block")


def _parse_exemplar(
    lineno: int, raw: str
) -> tuple[tuple, float, float | None]:
    """Parse an OpenMetrics exemplar tail ``{labels} value [timestamp]``
    (the part after `` # ``); returns (labels, value, timestamp)."""
    raw = raw.strip()
    if not raw.startswith("{"):
        raise ExpositionError(lineno, f"exemplar must start with '{{': {raw!r}")
    end = _label_block_end(lineno, raw)
    labels = _parse_labels(lineno, raw[1:end])
    fields = raw[end + 1:].split()
    if len(fields) not in (1, 2):
        raise ExpositionError(lineno, f"malformed exemplar tail: {raw!r}")
    value = _parse_value(lineno, fields[0])
    if not math.isfinite(value):
        raise ExpositionError(lineno, f"exemplar value not finite: {value}")
    ts = None
    if len(fields) == 2:
        ts = _parse_value(lineno, fields[1])
        if not math.isfinite(ts):
            raise ExpositionError(lineno, "exemplar timestamp not finite")
    return labels, value, ts


_HIST_SUFFIXES = ("_bucket", "_sum", "_count")
_SUMMARY_SUFFIXES = ("_sum", "_count")


def _family_of(name: str, types: dict) -> str | None:
    """Resolve a sample name to its declared family (suffix-aware)."""
    if name in types:
        return name
    for suffix in _HIST_SUFFIXES:
        if name.endswith(suffix):
            base = name[: -len(suffix)]
            kind = types.get(base)
            if kind == "histogram":
                return base
            if kind == "summary" and suffix in _SUMMARY_SUFFIXES:
                return base
    return None


def parse_exposition(text: str) -> dict:
    """Parse + validate; returns ``{family: {"type", "help", "samples"}}``
    where samples are ``(name, labels-tuple, value)``. Raises
    ``ExpositionError`` on any strict-format violation."""
    if text and not text.endswith("\n"):
        raise ExpositionError(text.count("\n") + 1, "payload must end with \\n")
    types: dict[str, str] = {}
    helps: dict[str, str] = {}
    samples: dict[str, list] = {}
    exemplars: dict[str, list] = {}
    seen_series: set[tuple] = set()
    families_with_samples: set[str] = set()

    for lineno, line in enumerate(text.split("\n"), start=1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 2 and parts[1] in ("TYPE", "HELP"):
                if len(parts) < 3 or not _NAME_RE.match(parts[2]):
                    raise ExpositionError(lineno, f"malformed {parts[1]} line")
                fname = parts[2]
                if parts[1] == "TYPE":
                    kind = parts[3].strip() if len(parts) > 3 else ""
                    if kind not in _TYPES:
                        raise ExpositionError(lineno, f"unknown type {kind!r}")
                    if fname in types:
                        raise ExpositionError(lineno, f"duplicate TYPE {fname}")
                    if fname in families_with_samples:
                        raise ExpositionError(
                            lineno, f"TYPE {fname} after its samples"
                        )
                    types[fname] = kind
                else:
                    helps[fname] = parts[3] if len(parts) > 3 else ""
            continue  # other comments are allowed
        # sample line: name[{labels}] value [timestamp]
        m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{)?", line)
        if not m:
            raise ExpositionError(lineno, f"malformed sample: {line!r}")
        name = m.group(1)
        rest = line[len(name):]
        labels: tuple = ()
        if rest.startswith("{"):
            end = _label_block_end(lineno, rest)
            labels = _parse_labels(lineno, rest[1:end])
            rest = rest[end + 1:]
        exemplar = None
        if " # " in rest:
            # OpenMetrics exemplar: `` # {labels} value [timestamp]``
            rest, _, ex_raw = rest.partition(" # ")
            exemplar = _parse_exemplar(lineno, ex_raw)
        fields = rest.split()
        if len(fields) not in (1, 2):
            raise ExpositionError(lineno, f"malformed sample tail: {rest!r}")
        value = _parse_value(lineno, fields[0])
        family = _family_of(name, types)
        if family is None:
            raise ExpositionError(
                lineno, f"sample {name!r} has no preceding TYPE declaration"
            )
        series_key = (name, labels)
        if series_key in seen_series:
            raise ExpositionError(lineno, f"duplicate series {series_key!r}")
        seen_series.add(series_key)
        families_with_samples.add(family)
        if types[family] == "counter" and not (
            value >= 0 and math.isfinite(value)
        ):
            raise ExpositionError(
                lineno, f"counter {name} has invalid value {value}"
            )
        if exemplar is not None:
            if types[family] != "histogram" or not name.endswith("_bucket"):
                raise ExpositionError(
                    lineno, f"exemplar on non-bucket sample {name!r}"
                )
            exemplars.setdefault(family, []).append(
                (name, labels) + exemplar
            )
        samples.setdefault(family, []).append((name, labels, value))

    _validate_histograms(types, samples)
    return {
        fam: {
            "type": kind,
            "help": helps.get(fam, ""),
            "samples": samples.get(fam, []),
            "exemplars": exemplars.get(fam, []),
        }
        for fam, kind in types.items()
    }


def _validate_histograms(types: dict, samples: dict) -> None:
    for fam, kind in types.items():
        if kind != "histogram":
            continue
        # group by the non-le label set
        by_series: dict[tuple, dict] = {}
        for name, labels, value in samples.get(fam, []):
            base_labels = tuple(lv for lv in labels if lv[0] != "le")
            entry = by_series.setdefault(
                base_labels, {"buckets": [], "sum": None, "count": None}
            )
            if name == fam + "_bucket":
                le = dict(labels).get("le")
                if le is None:
                    raise ExpositionError(0, f"{fam}_bucket missing le label")
                entry["buckets"].append((_parse_value(0, le), value))
            elif name == fam + "_sum":
                entry["sum"] = value
            elif name == fam + "_count":
                entry["count"] = value
        for base_labels, entry in by_series.items():
            buckets = entry["buckets"]
            if not buckets or entry["sum"] is None or entry["count"] is None:
                raise ExpositionError(
                    0, f"{fam}{dict(base_labels)}: incomplete histogram"
                )
            bounds = [b for b, _ in buckets]
            if bounds != sorted(bounds):
                raise ExpositionError(
                    0, f"{fam}{dict(base_labels)}: le bounds not sorted"
                )
            counts = [c for _, c in buckets]
            if counts != sorted(counts):
                raise ExpositionError(
                    0, f"{fam}{dict(base_labels)}: buckets not cumulative"
                )
            if not math.isinf(bounds[-1]):
                raise ExpositionError(
                    0, f"{fam}{dict(base_labels)}: missing le=\"+Inf\" bucket"
                )
            if counts[-1] != entry["count"]:
                raise ExpositionError(
                    0,
                    f"{fam}{dict(base_labels)}: +Inf bucket != _count "
                    f"({counts[-1]} vs {entry['count']})",
                )
