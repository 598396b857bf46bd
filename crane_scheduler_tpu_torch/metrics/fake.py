"""Fake metrics source for tests and the simulator.

Copy of ``crane_scheduler_tpu/metrics/fake.py``.
"""

from __future__ import annotations

from typing import Callable

from ..loadstore.codec import format_metric_value
from .source import MetricsQueryError


class FakeMetricsSource:
    """Dict-backed metrics with per-key failure injection.

    Values may be floats or zero-arg callables (synthetic streams).
    Keys are (metric_name, node_ip) and/or (metric_name, node_name);
    the annotator tries IP first and falls back to the name, like the
    reference (ref: pkg/controller/annotator/node.go:101-111).
    """

    def __init__(self):
        self._by_ip: dict[tuple[str, str], float | Callable[[], float]] = {}
        self._by_name: dict[tuple[str, str], float | Callable[[], float]] = {}
        # per-metric view of _by_ip: a bulk query walks one metric's
        # instances, not every (metric, instance) pair ever set
        self._ip_by_metric: dict[str, dict[str, float | Callable[[], float]]] = {}
        self._fail_ip: set[tuple[str, str]] = set()
        self._fail_name: set[tuple[str, str]] = set()
        # column providers: metric -> zero-arg fn returning the whole
        # {instance: rendered_value} column in one call (the simulator's
        # vectorized load model; per-instance closures cost ~5us x
        # |nodes| x |metrics| per sweep)
        self._columns: dict[str, Callable[[], dict[str, str]]] = {}
        # (metric, offset) -> {instance: rendered value} historical data
        self._offset_columns: dict[tuple[str, str], dict[str, str]] = {}
        self.ip_queries = 0
        self.name_queries = 0

    def set_column(self, metric: str, fn: Callable[[], dict[str, str]]) -> None:
        """Register a bulk column provider for ``metric``. ``fn`` must
        return ``{instance: value_str}`` with the Prometheus rendering
        contract already applied (clamped >= 0, 5-decimal fixed,
        ref: prometheus.go:120-125). Per-instance failure injection via
        ``fail`` still applies on top."""
        self._columns[metric] = fn

    def set(self, metric: str, node: str, value, by: str = "both") -> None:
        if by in ("ip", "both"):
            self._by_ip[(metric, node)] = value
            self._ip_by_metric.setdefault(metric, {})[node] = value
            # a per-instance override after a column provider was
            # registered must win on the bulk path too — drop the column
            # so bulk queries fall back to the per-instance values
            self._columns.pop(metric, None)
        if by in ("name", "both"):
            self._by_name[(metric, node)] = value

    def fail(self, metric: str, node: str, by: str = "both") -> None:
        if by in ("ip", "both"):
            self._fail_ip.add((metric, node))
        if by in ("name", "both"):
            self._fail_name.add((metric, node))

    def clear_failures(self) -> None:
        self._fail_ip.clear()
        self._fail_name.clear()

    @staticmethod
    def _render(value) -> str:
        if callable(value):
            value = value()
        # Mirror the Prometheus client's clamping + 5-decimal rendering
        # (ref: prometheus.go:120-125).
        value = float(value)
        if value != value or value < 0:  # NaN or negative
            value = 0.0
        return format_metric_value(value)

    def set_offset_column(self, metric: str, offset: str, values: dict) -> None:
        """Historical column for ``query_all_by_metric(offset=...)``:
        ``{instance: float}`` as the value one ``offset`` ago."""
        self._offset_columns[(metric, offset)] = {
            inst: self._render(v) for inst, v in values.items()
        }

    def query_all_by_metric(self, metric_name: str, offset: str | None = None) -> dict:
        """Bulk variant: every known instance's value for one metric."""
        if offset is not None:
            column = self._offset_columns.get((metric_name, offset))
            if column is None:
                raise MetricsQueryError(
                    f"no offset data for {metric_name} offset {offset}"
                )
            return dict(column)
        fail = self._fail_ip
        column = self._columns.get(metric_name)
        if column is not None:
            out = column()
            if fail:
                # fault injection needs the mapping form; column
                # providers may serve aligned (hosts, values[, floats])
                # tuples
                if isinstance(out, tuple):
                    out = dict(zip(out[0], out[1]))
                for instance in [
                    i for i in out if (metric_name, i) in fail
                ]:
                    del out[instance]
            return out
        out = {}
        render = self._render
        for instance, value in self._ip_by_metric.get(metric_name, {}).items():
            if (metric_name, instance) not in fail:
                out[instance] = render(value)
        return out

    def query_by_node_ip(self, metric_name: str, ip: str) -> str:
        self.ip_queries += 1
        key = (metric_name, ip)
        if key in self._fail_ip or key not in self._by_ip:
            raise MetricsQueryError(f"no data for {metric_name}{{instance={ip}}}")
        return self._render(self._by_ip[key])

    def query_by_node_name(self, metric_name: str, name: str) -> str:
        self.name_queries += 1
        key = (metric_name, name)
        if key in self._fail_name or key not in self._by_name:
            raise MetricsQueryError(f"no data for {metric_name}{{instance={name}}}")
        return self._render(self._by_name[key])
