"""Thread-safe metrics registry with Prometheus text exposition.

Copy of ``crane_scheduler_tpu/telemetry/registry.py``.

The Go scheduler exports no metrics: its only latency visibility is
log lines. This registry is the one measurement surface
every subsystem (scheduler, parallel, annotator, cluster, service)
writes into: Counter / Gauge / log-bucketed Histogram primitives with
labels, rendered in the Prometheus text exposition format (``# HELP`` /
``# TYPE``, ``_bucket``/``_sum``/``_count`` with cumulative ``le``
buckets) that real scrapers consume.

Design points:

- stdlib-only, no prometheus_client dependency (the container must not
  grow deps);
- get-or-create families (``registry.counter(...)`` twice returns the
  same object) so instrumented modules don't coordinate construction;
- per-child locks on the write path — hot-path cost is one lock and one
  float add, cheap enough that the bench's pipelined p99 budget (<3%
  overhead) holds;
- deterministic rendering (families and children sorted) so exposition
  output is golden-file testable.
"""

from __future__ import annotations

import math
import re
import threading
import time

_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
# suffixes the histogram renderer owns; bare families must not collide
_RESERVED_SUFFIXES = ("_bucket", "_sum", "_count")


def log_buckets(start: float, factor: float, count: int) -> tuple[float, ...]:
    """Log-spaced histogram bounds: ``start * factor**i`` for i < count
    (the +Inf bucket is implicit)."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    return tuple(start * factor**i for i in range(count))


# default latency buckets: 50us .. ~26s in x2 steps — wide enough for
# both a sub-ms device dispatch and a multi-second cold refresh
DEFAULT_LATENCY_BUCKETS = log_buckets(5e-5, 2.0, 20)


def format_value(v: float) -> str:
    """Exposition float rendering: integers without the trailing ``.0``
    (Go-style), ``+Inf``/``-Inf``/``NaN`` spelled the Prometheus way."""
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


class _Child:
    """One labeled series; subclasses own the sample math."""

    __slots__ = ("_lock",)

    def __init__(self):
        self._lock = threading.Lock()


class CounterChild(_Child):
    __slots__ = ("_value",)

    def __init__(self):
        super().__init__()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class GaugeChild(_Child):
    __slots__ = ("_value",)

    def __init__(self):
        super().__init__()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class HistogramChild(_Child):
    __slots__ = ("_bounds", "_counts", "_sum", "_total", "_exemplars")

    def __init__(self, bounds: tuple[float, ...]):
        super().__init__()
        self._bounds = bounds
        self._counts = [0] * len(bounds)
        self._sum = 0.0
        self._total = 0
        # OpenMetrics exemplars: bucket index -> (labels, value, unix ts);
        # index len(bounds) is the +Inf bucket. Lazy — the common
        # observe() path never allocates it.
        self._exemplars: dict | None = None

    def observe(self, value: float, exemplar: dict | None = None) -> None:
        with self._lock:
            self._sum += value
            self._total += 1
            idx = len(self._bounds)
            # linear scan beats bisect below ~30 bounds (no call overhead)
            for i, b in enumerate(self._bounds):
                if value <= b:
                    self._counts[i] += 1
                    idx = i
                    break
            if exemplar is not None:
                if self._exemplars is None:
                    self._exemplars = {}
                self._exemplars[idx] = (dict(exemplar), value, time.time())

    def snapshot(self) -> tuple[list[int], float, int]:
        """(per-bucket counts, sum, total count) — non-cumulative."""
        with self._lock:
            return list(self._counts), self._sum, self._total

    def snapshot_exemplars(self) -> dict:
        """Latest exemplar per bucket index (may be empty)."""
        with self._lock:
            return dict(self._exemplars) if self._exemplars else {}


class _Family:
    """One named metric family; children keyed on label-value tuples."""

    kind = ""

    def __init__(self, name: str, help: str, labelnames: tuple[str, ...]):
        if not _METRIC_NAME_RE.match(name):
            raise ValueError(f"invalid metric name: {name!r}")
        for ln in labelnames:
            if not _LABEL_NAME_RE.match(ln):
                raise ValueError(f"invalid label name: {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: dict[tuple[str, ...], _Child] = {}
        self._lock = threading.Lock()

    def _new_child(self) -> _Child:
        raise NotImplementedError

    def labels(self, *values, **kv) -> _Child:
        if kv:
            if values:
                raise ValueError("pass label values positionally OR by name")
            values = tuple(str(kv[ln]) for ln in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got {values}"
            )
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = self._new_child()
            return child

    def _default(self) -> _Child:
        return self.labels()

    def children(self) -> list[tuple[tuple[str, ...], _Child]]:
        with self._lock:
            return sorted(self._children.items())

    def _label_str(self, values: tuple[str, ...], extra: str = "") -> str:
        parts = [
            f'{ln}="{_escape_label_value(lv)}"'
            for ln, lv in zip(self.labelnames, values)
        ]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""


class Counter(_Family):
    kind = "counter"

    def _new_child(self):
        return CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    @property
    def value(self) -> float:
        return self._default().value

    def render_into(self, out: list[str], openmetrics: bool = False) -> None:
        for values, child in self.children():
            out.append(
                f"{self.name}{self._label_str(values)} "
                f"{format_value(child.value)}"
            )


class Gauge(_Family):
    kind = "gauge"

    def _new_child(self):
        return GaugeChild()

    def set(self, value: float) -> None:
        self._default().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)

    @property
    def value(self) -> float:
        return self._default().value

    render_into = Counter.render_into


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name, help, labelnames, buckets=None):
        super().__init__(name, help, labelnames)
        bounds = tuple(float(b) for b in (buckets or DEFAULT_LATENCY_BUCKETS))
        if list(bounds) != sorted(set(bounds)):
            raise ValueError("histogram buckets must be strictly increasing")
        self.buckets = bounds

    def _new_child(self):
        return HistogramChild(self.buckets)

    def observe(self, value: float, exemplar: dict | None = None) -> None:
        self._default().observe(value, exemplar=exemplar)

    def time(self):
        """Context manager observing the block's wall seconds."""
        return _HistogramTimer(self._default())

    @staticmethod
    def _exemplar_str(ex) -> str:
        """OpenMetrics exemplar tail: `` # {labels} value timestamp``."""
        labels, value, ts = ex
        inner = ",".join(
            f'{k}="{_escape_label_value(str(v))}"'
            for k, v in sorted(labels.items())
        )
        return f" # {{{inner}}} {format_value(value)} {ts:.3f}"

    def render_into(self, out: list[str], openmetrics: bool = False) -> None:
        for values, child in self.children():
            counts, total_sum, total = child.snapshot()
            exemplars = child.snapshot_exemplars() if openmetrics else {}
            running = 0
            for i, (bound, c) in enumerate(zip(self.buckets, counts)):
                running += c
                le = f'le="{format_value(bound)}"'
                tail = ""
                if i in exemplars:
                    tail = self._exemplar_str(exemplars[i])
                out.append(
                    f"{self.name}_bucket{self._label_str(values, le)} "
                    f"{running}{tail}"
                )
            inf_label = 'le="+Inf"'
            inf_tail = ""
            if len(self.buckets) in exemplars:
                inf_tail = self._exemplar_str(exemplars[len(self.buckets)])
            out.append(
                f"{self.name}_bucket{self._label_str(values, inf_label)} "
                f"{total}{inf_tail}"
            )
            out.append(
                f"{self.name}_sum{self._label_str(values)} "
                f"{format_value(total_sum)}"
            )
            out.append(f"{self.name}_count{self._label_str(values)} {total}")


class _HistogramTimer:
    __slots__ = ("_child", "_start")

    def __init__(self, child: HistogramChild):
        self._child = child

    def __enter__(self):
        import time

        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import time

        self._child.observe(time.perf_counter() - self._start)
        return False


class _Reading:
    """One series value read at render time (``CounterFunc``)."""

    __slots__ = ("value",)

    def __init__(self, value: float):
        self.value = value


class CounterFunc(Counter):
    """A counter family whose series are read at render time from
    ``read()`` (``{label values: value}``): for totals kept by code that
    must take no lock, such as a ``gc.callbacks`` hook."""

    def __init__(self, name, help, labelnames, read):
        super().__init__(name, help, labelnames)
        self._read = read

    def children(self):
        return sorted((tuple(str(v) for v in values), _Reading(float(value)))
                      for values, value in self._read().items())


class MetricsRegistry:
    """Named families, get-or-create, rendered deterministically."""

    def __init__(self):
        self._families: dict[str, _Family] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labelnames, **kw) -> _Family:
        labelnames = tuple(labelnames)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or fam.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered with a "
                        f"different type or label set"
                    )
                return fam
            for fname in self._families:
                # a histogram's rendered suffixes must not collide with
                # an existing bare family (and vice versa)
                for suffix in _RESERVED_SUFFIXES:
                    if cls is Histogram and fname == name + suffix:
                        raise ValueError(
                            f"histogram {name!r} collides with {fname!r}"
                        )
                    if (
                        isinstance(self._families[fname], Histogram)
                        and name == fname + suffix
                    ):
                        raise ValueError(
                            f"metric {name!r} collides with histogram "
                            f"{fname!r}"
                        )
            fam = self._families[name] = cls(name, help, labelnames, **kw)
            return fam

    def counter(self, name: str, help: str = "", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def counter_func(self, name: str, help: str, labelnames, read) -> CounterFunc:
        return self._get_or_create(CounterFunc, name, help, labelnames, read=read)

    def gauge(self, name: str, help: str = "", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(
        self, name: str, help: str = "", labelnames=(), buckets=None
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def families(self) -> list[_Family]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def render(self, openmetrics: bool = False) -> str:
        """Prometheus text exposition (version 0.0.4), or the OpenMetrics
        variant (``openmetrics=True``): histogram buckets carry their
        latest exemplar and the payload ends with ``# EOF``."""
        out: list[str] = []
        for fam in self.families():
            if fam.help:
                out.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
            out.append(f"# TYPE {fam.name} {fam.kind}")
            fam.render_into(out, openmetrics=openmetrics)
        if openmetrics:
            out.append("# EOF")
        return "\n".join(out) + "\n" if out else ""

    def snapshot(self) -> dict:
        """Flat ``{series: value}`` view (bench/JSON artifacts); histogram
        families contribute ``_sum``/``_count`` only."""
        flat: dict[str, float] = {}
        for fam in self.families():
            for values, child in fam.children():
                series = fam.name + fam._label_str(values)
                if isinstance(child, HistogramChild):
                    _, s, n = child.snapshot()
                    flat[fam.name + "_sum" + fam._label_str(values)] = s
                    flat[fam.name + "_count" + fam._label_str(values)] = n
                else:
                    flat[series] = child.value
        return flat
