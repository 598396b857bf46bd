"""Health registry: one place that knows how degraded the process is.

Copy of ``crane_scheduler_tpu/resilience/health.py``.

Components report ``healthy`` / ``degraded`` / ``failed`` with a
reason; the registry aggregates (overall = worst component) and is
served on every ``/healthz`` plus exported as
``crane_health_state{component}`` gauges (0 healthy / 1 degraded /
2 failed).

A breaker can be bound to a component with ``watch_breaker`` so its
open/half-open/closed transitions flip health automatically:
open -> degraded ("fail-open on <target>"), closed -> healthy.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional


class HealthState:
    HEALTHY = "healthy"
    DEGRADED = "degraded"
    FAILED = "failed"


_STATE_CODE = {
    HealthState.HEALTHY: 0,
    HealthState.DEGRADED: 1,
    HealthState.FAILED: 2,
}
_STATE_RANK = _STATE_CODE  # worst-of aggregation uses the same order


class HealthRegistry:
    def __init__(self, telemetry=None):
        self._lock = threading.Lock()
        self._components: Dict[str, tuple[str, str]] = {}
        self._m_state = None
        if telemetry is not None:
            self._m_state = telemetry.registry.gauge(
                "crane_health_state",
                "Component health (0 healthy, 1 degraded, 2 failed)",
                ("component",),
            )

    def set(
        self, component: str, state: str, reason: str = ""
    ) -> None:
        if state not in _STATE_CODE:
            raise ValueError(f"unknown health state {state!r}")
        with self._lock:
            self._components[component] = (state, reason)
        if self._m_state is not None:
            self._m_state.labels(component=component).set(_STATE_CODE[state])

    def get(self, component: str) -> Optional[tuple[str, str]]:
        with self._lock:
            return self._components.get(component)

    def overall(self) -> str:
        with self._lock:
            if not self._components:
                return HealthState.HEALTHY
            return max(
                (s for s, _ in self._components.values()),
                key=_STATE_RANK.__getitem__,
            )

    def snapshot(self) -> dict:
        """The ``/healthz`` payload."""
        with self._lock:
            components = {
                name: {"state": state, "reason": reason}
                for name, (state, reason) in sorted(self._components.items())
            }
        if not components:
            overall = HealthState.HEALTHY
        else:
            overall = max(
                (c["state"] for c in components.values()),
                key=_STATE_RANK.__getitem__,
            )
        return {"status": overall, "components": components}

    def watch_breaker(
        self, breaker, component: Optional[str] = None
    ) -> Callable[[str, str], None]:
        """Bind ``breaker`` transitions to ``component`` health. Installs
        (and returns) the transition callback; chains any callback the
        breaker already had."""
        name = component or breaker.target
        self.set(name, HealthState.HEALTHY)
        prev = getattr(breaker, "_on_transition", None)

        def _on_transition(target: str, to: str) -> None:
            if to == "open":
                self.set(
                    name, HealthState.DEGRADED, f"breaker open on {target}"
                )
            elif to == "half-open":
                self.set(
                    name, HealthState.DEGRADED, f"probing {target}"
                )
            else:
                self.set(name, HealthState.HEALTHY)
            if prev is not None:
                prev(target, to)

        breaker._on_transition = _on_transition
        return _on_transition
