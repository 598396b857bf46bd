"""Circuit breaker: closed / open / half-open over a sliding window.

Copy of ``crane_scheduler_tpu/resilience/breaker.py``.

One instance per fault *target* (prometheus, kube-read, kube-write,
device-dispatch). The breaker never raises from ``record_*`` and is
safe to consult from hot paths: ``allow()`` is a couple of comparisons
under a lock.

State machine:

- **closed** — requests flow; failures land in a sliding time window.
  When the window holds >= ``failure_threshold`` failures AND at least
  ``min_calls`` total calls, trip to open.
- **open** — requests are rejected (``allow()`` False / ``call()``
  raises ``BreakerOpenError``) until ``reset_timeout_s`` elapses, then
  the next ``allow()`` transitions to half-open and admits it as the
  probe.
- **half-open** — up to ``half_open_max_probes`` in-flight probes are
  admitted; one success closes the breaker and clears the window, one
  failure re-opens it and restarts the timer.

Telemetry (all gated on a live registry): ``crane_breaker_state{target}``
gauge (0 closed / 1 half-open / 2 open), ``crane_breaker_transitions_total
{target,to}`` and ``crane_breaker_rejected_total{target}`` counters.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional


class BreakerState:
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half-open"


# gauge encoding for crane_breaker_state
_STATE_CODE = {
    BreakerState.CLOSED: 0,
    BreakerState.HALF_OPEN: 1,
    BreakerState.OPEN: 2,
}


class BreakerOpenError(Exception):
    """Raised by ``call()`` when the breaker rejects the request."""

    def __init__(self, target: str, retry_after_s: float = 0.0):
        super().__init__(f"circuit breaker open for {target!r}")
        self.target = target
        self.retry_after_s = retry_after_s


class CircuitBreaker:
    def __init__(
        self,
        target: str,
        *,
        failure_threshold: int = 5,
        window_s: float = 30.0,
        reset_timeout_s: float = 15.0,
        min_calls: int = 1,
        half_open_max_probes: int = 1,
        clock: Callable[[], float] = time.monotonic,
        telemetry=None,
        on_transition: Optional[Callable[[str, str], None]] = None,
    ):
        self.target = target
        self.failure_threshold = max(1, int(failure_threshold))
        self.window_s = float(window_s)
        self.reset_timeout_s = float(reset_timeout_s)
        self.min_calls = max(1, int(min_calls))
        self.half_open_max_probes = max(1, int(half_open_max_probes))
        self._clock = clock
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._state = BreakerState.CLOSED
        self._failures: deque[float] = deque()  # failure timestamps
        self._calls: deque[float] = deque()  # all call timestamps
        self._opened_at = 0.0
        self._probes_in_flight = 0

        self._m_state = None
        self._m_transitions = None
        self._m_rejected = None
        if telemetry is not None:
            reg = telemetry.registry
            self._m_state = reg.gauge(
                "crane_breaker_state",
                "Circuit breaker state (0 closed, 1 half-open, 2 open)",
                ("target",),
            )
            self._m_transitions = reg.counter(
                "crane_breaker_transitions_total",
                "Circuit breaker state transitions",
                ("target", "to"),
            )
            self._m_rejected = reg.counter(
                "crane_breaker_rejected_total",
                "Requests rejected by an open circuit breaker",
                ("target",),
            )
            self._m_state.labels(target=target).set(0)

    # -- state inspection ------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._effective_state(self._clock())

    def _effective_state(self, now: float) -> str:
        # open -> half-open is a lazy transition evaluated on read, so a
        # sleeping process doesn't need a timer thread to recover.
        if (
            self._state == BreakerState.OPEN
            and now - self._opened_at >= self.reset_timeout_s
        ):
            self._transition(BreakerState.HALF_OPEN)
        return self._state

    # -- admission -------------------------------------------------------

    def allow(self) -> bool:
        """Admit or reject one request. Must be paired with exactly one
        ``record_success``/``record_failure`` when admitted."""
        with self._lock:
            now = self._clock()
            state = self._effective_state(now)
            if state == BreakerState.CLOSED:
                return True
            if state == BreakerState.HALF_OPEN:
                if self._probes_in_flight < self.half_open_max_probes:
                    self._probes_in_flight += 1
                    return True
                if self._m_rejected is not None:
                    self._m_rejected.labels(target=self.target).inc()
                return False
            if self._m_rejected is not None:
                self._m_rejected.labels(target=self.target).inc()
            return False

    def retry_after_s(self) -> float:
        """Seconds until the breaker would admit a probe (0 if now)."""
        with self._lock:
            if self._state != BreakerState.OPEN:
                return 0.0
            return max(
                0.0, self.reset_timeout_s - (self._clock() - self._opened_at)
            )

    # -- outcome recording -----------------------------------------------

    def record_success(self) -> None:
        with self._lock:
            now = self._clock()
            state = self._effective_state(now)
            if state == BreakerState.HALF_OPEN:
                self._probes_in_flight = max(0, self._probes_in_flight - 1)
                self._failures.clear()
                self._calls.clear()
                self._transition(BreakerState.CLOSED)
                return
            self._calls.append(now)
            self._prune(now)

    def record_failure(self) -> None:
        with self._lock:
            now = self._clock()
            state = self._effective_state(now)
            if state == BreakerState.HALF_OPEN:
                self._probes_in_flight = max(0, self._probes_in_flight - 1)
                self._opened_at = now
                self._transition(BreakerState.OPEN)
                return
            if state == BreakerState.OPEN:
                return
            self._calls.append(now)
            self._failures.append(now)
            self._prune(now)
            if (
                len(self._failures) >= self.failure_threshold
                and len(self._calls) >= self.min_calls
            ):
                self._opened_at = now
                self._transition(BreakerState.OPEN)

    # -- convenience wrapper ----------------------------------------------

    def call(self, fn, *args, **kwargs):
        """Run ``fn`` under the breaker; raises ``BreakerOpenError`` when
        rejected, records the outcome otherwise and re-raises failures."""
        if not self.allow():
            raise BreakerOpenError(self.target, self.retry_after_s())
        try:
            result = fn(*args, **kwargs)
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return result

    # -- internals --------------------------------------------------------

    def _prune(self, now: float) -> None:
        horizon = now - self.window_s
        while self._failures and self._failures[0] < horizon:
            self._failures.popleft()
        while self._calls and self._calls[0] < horizon:
            self._calls.popleft()

    def _transition(self, to: str) -> None:
        # caller holds self._lock
        if self._state == to:
            return
        self._state = to
        if to != BreakerState.HALF_OPEN:
            self._probes_in_flight = 0
        if self._m_state is not None:
            self._m_state.labels(target=self.target).set(_STATE_CODE[to])
            self._m_transitions.labels(target=self.target, to=to).inc()
        cb = self._on_transition
        if cb is not None:
            try:
                cb(self.target, to)
            except Exception:
                pass
