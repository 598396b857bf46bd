"""Unified telemetry: metrics registry + span recorder + decision traces.

Counterpart of ``crane_scheduler_tpu/telemetry/__init__.py``. One
measurement layer threaded through the burst path (``BatchScheduler``,
``ScheduleStep``), the drip path (``Scheduler``, ``DripColumns``,
``FitTracker``) and the scoring sidecar (``service``). Four surfaces, one
bundle:

- ``MetricsRegistry`` — Counter/Gauge/log-bucketed Histogram with real
  Prometheus text exposition;
- ``SpanRecorder`` — pipelined-loop stage spans exported as Chrome
  trace-event JSON (Perfetto / ``chrome://tracing``), alongside the
  ``utils.profiling.torch_trace`` device-level hook;
- ``DecisionTraceBuffer`` — sampled per-decision traces, bounded memory;
- ``PodLifecycleTracker`` — per-pod stage timestamps (seen -> filtered
  -> scored -> bind_post), with an optional on-disk ``FlightRecorder``.

Port-only: ``stages.StageClock`` splits the drip window into stages on
one clock for the counters, the spans and ``torch.profiler``
(``profiler_ranges()`` puts every span and stage in the profiler's
trace); ``gcpause.GC_PAUSES`` counts the collector's pauses.

The fleet plane (``fleet``: ``FleetPlane``, ``MetricsFederator``,
``SLOEngine``, ``FleetAnomalies``) federates many processes' ``/metrics``
and serves burn-rate SLOs; the sidecar mounts it.

Instrumented modules accept ``telemetry=`` and fall back to the
process-global instance (``active()``), which is None unless enabled —
so the disabled hot path costs one attribute check. Enable explicitly
with ``telemetry.enable()`` or by setting ``CRANE_TELEMETRY=1`` in the
environment before first use.
"""

from __future__ import annotations

import contextlib
import os
import threading

from . import stages, tracing
from .decisions import DecisionTraceBuffer
from .fleet import (
    FleetAnomalies,
    FleetPlane,
    MetricsFederator,
    ScrapeTarget,
    SLOEngine,
    process_role,
    register_build_info,
    set_process_role,
)
from .gcpause import GC_PAUSES
from .lifecycle import FlightRecorder, PodLifecycleTracker, slo_report
from .registry import (
    DEFAULT_LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    log_buckets,
)
from .spans import SpanRecorder
from .stages import StageClock, profiler_ranges

__all__ = [
    "Telemetry",
    "MetricsRegistry",
    "SpanRecorder",
    "StageClock",
    "profiler_ranges",
    "GC_PAUSES",
    "DecisionTraceBuffer",
    "PodLifecycleTracker",
    "FlightRecorder",
    "slo_report",
    "FleetPlane",
    "MetricsFederator",
    "SLOEngine",
    "FleetAnomalies",
    "ScrapeTarget",
    "register_build_info",
    "set_process_role",
    "process_role",
    "tracing",
    "Counter",
    "Gauge",
    "Histogram",
    "log_buckets",
    "DEFAULT_LATENCY_BUCKETS",
    "enable",
    "disable",
    "active",
    "maybe_span",
    "flush_on_signal",
]


class Telemetry:
    """The bundle instrumented modules share."""

    def __init__(
        self,
        registry: MetricsRegistry | None = None,
        spans: SpanRecorder | None = None,
        decisions: DecisionTraceBuffer | None = None,
        lifecycle: PodLifecycleTracker | None = None,
        span_capacity: int = 16384,
        decision_capacity: int = 512,
        decision_sample_every: int = 1,
        lifecycle_capacity: int = 8192,
        flight_dir: str | None = None,
        flight_fsync: bool | None = None,
    ):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.spans = (
            spans if spans is not None else SpanRecorder(capacity=span_capacity)
        )
        self.decisions = (
            decisions
            if decisions is not None
            else DecisionTraceBuffer(
                capacity=decision_capacity,
                sample_every=decision_sample_every,
            )
        )
        if flight_dir is None:
            flight_dir = os.environ.get("CRANE_FLIGHT_DIR") or None
        if flight_fsync is None:
            env = os.environ.get("CRANE_FLIGHT_FSYNC", "").strip().lower()
            flight_fsync = bool(env) and env not in ("0", "false", "no")
        self.flight = (
            FlightRecorder(flight_dir, fsync=flight_fsync)
            if flight_dir else None
        )
        self.lifecycle = (
            lifecycle
            if lifecycle is not None
            else PodLifecycleTracker(
                registry=self.registry,
                spans=self.spans,
                capacity=lifecycle_capacity,
                flight=self.flight,
            )
        )
        # incremental flight-drain cursors (flush_flight)
        self._span_cursor = 0
        self._decision_cursor = 0
        self._flush_lock = threading.Lock()
        if self.flight is not None:
            # stream spans to disk without explicit wiring: the CLIs
            # never pump flush_flight themselves, and a crash is exactly
            # when the tail matters
            import atexit

            self._flight_stop = threading.Event()
            threading.Thread(
                target=self._flight_pump,
                name="crane-flight-flush",
                daemon=True,
            ).start()
            atexit.register(self.flush_flight)

    def render_prometheus(self, openmetrics: bool = False) -> str:
        return self.registry.render(openmetrics=openmetrics)

    def export_chrome_trace(self) -> dict:
        return self.spans.export_chrome_trace()

    def flush_flight(self) -> dict:
        """Drain spans + decision traces recorded since the last call
        into the flight recorder (lifecycle records stream on completion
        already). A flight-enabled bundle also pumps this from a daemon
        thread every second, plus once at interpreter exit. Returns
        written counts; no-op without a flight dir."""
        if self.flight is None:
            return {"spans": 0, "decisions": 0}
        with self._flush_lock:
            spans, self._span_cursor = self.spans.drain_since(
                self._span_cursor
            )
            decisions, self._decision_cursor = self.decisions.drain_since(
                self._decision_cursor
            )
            return {
                "spans": self.flight.write_many("span", spans),
                "decisions": self.flight.write_many("decision", decisions),
            }

    def _flight_pump(self) -> None:
        while not self._flight_stop.wait(1.0):
            try:
                self.flush_flight()
            except Exception:
                pass


_active: Telemetry | None = None
_lock = threading.Lock()
_gc_hooked = False  # enable() installed GC_PAUSES (disable() removes it)


def enable(telemetry: Telemetry | None = None) -> Telemetry:
    """Install (and return) the process-global telemetry instance, with
    the GC pause counter exported in its registry."""
    global _active, _gc_hooked
    with _lock:
        if telemetry is not None:
            _active = telemetry
        elif _active is None:
            _active = Telemetry()
        GC_PAUSES.export(_active.registry)
        _gc_hooked = GC_PAUSES.install() or _gc_hooked
        return _active


def disable() -> None:
    global _active, _gc_hooked
    with _lock:
        _active = None
        if _gc_hooked:
            GC_PAUSES.uninstall()
            _gc_hooked = False


def active() -> Telemetry | None:
    """The process-global instance, or None when disabled. Honors
    ``CRANE_TELEMETRY=1`` (any non-empty value but ``0``/``false``)."""
    if _active is None:
        env = os.environ.get("CRANE_TELEMETRY", "").strip().lower()
        if env and env not in ("0", "false", "no"):
            return enable()
    return _active


_NULL_CTX = contextlib.nullcontext()


def maybe_span(telemetry: Telemetry | None, name: str, **args):
    """``telemetry.spans.span(...)`` when enabled, a shared no-op context
    otherwise — the hot-path gating idiom. Under ``profiler_ranges()`` the
    span is also a ``torch.profiler`` range of the same name."""
    if stages.RANGES:
        return stages.ranged(telemetry, name, args)
    if telemetry is None:
        return _NULL_CTX
    return telemetry.spans.span(name, **args)


def flush_on_signal(telemetry: Telemetry, signum=None) -> None:
    """Install a SIGTERM handler that drains the flight recorder before
    the process dies. atexit only fires on orderly interpreter exit;
    SIGTERM's default action skips it entirely, so the last second of
    spans from an orderly kill was lost. Chains any previously-installed
    handler, and re-raises with the default disposition when there was
    none so exit status still reports the signal. Main-thread only (the
    CLIs qualify)."""
    import signal as _signal

    signum = _signal.SIGTERM if signum is None else signum
    prev = _signal.getsignal(signum)

    def _handler(num, frame):
        try:
            telemetry.flush_flight()
        except Exception:
            pass
        if callable(prev):
            prev(num, frame)
        elif prev == _signal.SIG_DFL:
            _signal.signal(num, _signal.SIG_DFL)
            os.kill(os.getpid(), num)

    _signal.signal(signum, _handler)

