"""Cluster-wide degraded-mode controller.

Copy of ``crane_scheduler_tpu/resilience/degraded.py``.

The oracle already fails open *per node*: a stale ``value,timestamp``
annotation just contributes the neutral score. But when the annotator
(or Prometheus) is down cluster-wide, *every* node silently degrades
to neutral — load-aware scoring becomes noise with no signal, no
hysteresis, and no safety interlock on the descheduler, which would
happily evict on stale load data.

This controller tracks the stale fraction across the node set using
the oracle's exact staleness semantics (``get_active_duration`` +
``in_active_period``: strict ``now < ts + active_duration``) and flips
one explicit mode bit with enter/exit hysteresis:

- **enter** degraded when stale_fraction > ``enter_fraction``;
- **exit** when stale_fraction < ``exit_fraction`` (< enter_fraction,
  so a cluster hovering at the threshold doesn't flap).

While degraded:

- the Dynamic plugin switches from load-aware scoring to
  resource-fit + spread-only scoring (one mode transition, not
  per-node neutral drift);
- the descheduler hard-suspends evictions (the one unsafe action in
  the system on stale data).

Telemetry: ``crane_degraded_mode`` gauge (0/1),
``crane_degraded_stale_fraction`` gauge, and
``crane_degraded_transitions_total{to}`` counter. When a
``HealthRegistry`` is attached the ``annotations`` component flips
degraded/healthy with the mode.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable, Optional, Tuple

from ..policy.types import PolicySpec
from ..scorer.oracle import get_active_duration, in_active_period
from .health import HealthState


class DegradedModeController:
    def __init__(
        self,
        spec: PolicySpec,
        *,
        enter_fraction: float = 0.5,
        exit_fraction: float = 0.25,
        min_nodes: int = 1,
        min_eval_interval_s: float = 5.0,
        telemetry=None,
        health=None,
        health_component: str = "annotations",
        on_transition: Optional[Callable[[bool, float], None]] = None,
    ):
        if not (0.0 <= exit_fraction <= enter_fraction <= 1.0):
            raise ValueError(
                "need 0 <= exit_fraction <= enter_fraction <= 1, got "
                f"exit={exit_fraction} enter={enter_fraction}"
            )
        self.spec = spec
        self.enter_fraction = float(enter_fraction)
        self.exit_fraction = float(exit_fraction)
        self.min_nodes = max(1, int(min_nodes))
        self.min_eval_interval_s = float(min_eval_interval_s)
        self._health = health
        self._health_component = health_component
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._active = False
        self._stale_fraction = 0.0
        self._last_eval_at = float("-inf")

        # metric names with a nonzero sync period: the ones the oracle
        # would actually read. A node is fresh iff at least one of them
        # carries a valid in-active-period annotation.
        self._tracked: Tuple[Tuple[str, float], ...] = tuple(
            (sp.name, get_active_duration(spec.sync_period, sp.name))
            for sp in spec.sync_period
            if sp.period_seconds != 0
        )

        self._m_mode = None
        if telemetry is not None:
            reg = telemetry.registry
            self._m_mode = reg.gauge(
                "crane_degraded_mode",
                "Cluster-wide degraded scheduling mode (0 off, 1 on)",
            )
            self._m_fraction = reg.gauge(
                "crane_degraded_stale_fraction",
                "Fraction of nodes with no fresh load annotation",
            )
            self._m_transitions = reg.counter(
                "crane_degraded_transitions_total",
                "Degraded-mode transitions",
                ("to",),
            )
            self._m_mode.set(0)

    # -- reads -------------------------------------------------------------

    @property
    def active(self) -> bool:
        with self._lock:
            return self._active

    @property
    def stale_fraction(self) -> float:
        with self._lock:
            return self._stale_fraction

    # -- staleness classification -----------------------------------------

    def node_is_stale(self, anno: Optional[dict], now: float) -> bool:
        """True when no tracked metric annotation would pass the oracle's
        active-period check (same semantics the score path applies)."""
        if not self._tracked:
            return False  # no sync policy => nothing can be stale
        if not anno:
            return True
        for name, active_duration in self._tracked:
            raw = anno.get(name)
            if raw is None:
                continue
            parts = raw.split(",")
            if len(parts) != 2:
                continue
            if in_active_period(parts[1], active_duration, now):
                return False
        return True

    # -- evaluation --------------------------------------------------------

    def update(
        self, annotations: Iterable[Optional[dict]], now: float
    ) -> bool:
        """Re-evaluate the stale fraction over one annotation sweep and
        apply hysteresis. Returns the (possibly new) mode."""
        total = 0
        stale = 0
        for anno in annotations:
            total += 1
            if self.node_is_stale(anno, now):
                stale += 1
        with self._lock:
            self._last_eval_at = now
            if total < self.min_nodes:
                # too few nodes to call a cluster-wide verdict; hold mode
                return self._active
            fraction = stale / total
            self._stale_fraction = fraction
            if self._m_mode is not None:
                self._m_fraction.set(fraction)
            if not self._active and fraction > self.enter_fraction:
                self._set_active(True, fraction)
            elif self._active and fraction < self.exit_fraction:
                self._set_active(False, fraction)
            return self._active

    def maybe_update(
        self, annotations_fn: Callable[[], Iterable[Optional[dict]]], now: float
    ) -> bool:
        """Throttled ``update`` for hot paths: re-evaluates at most every
        ``min_eval_interval_s``; otherwise returns the cached mode."""
        with self._lock:
            if now - self._last_eval_at < self.min_eval_interval_s:
                return self._active
        return self.update(annotations_fn(), now)

    # -- internals ---------------------------------------------------------

    def _set_active(self, active: bool, fraction: float) -> None:
        # caller holds self._lock
        self._active = active
        if self._m_mode is not None:
            self._m_mode.set(1 if active else 0)
            self._m_transitions.labels(
                to="degraded" if active else "healthy"
            ).inc()
        if self._health is not None:
            if active:
                self._health.set(
                    self._health_component,
                    HealthState.DEGRADED,
                    f"{fraction:.0%} of nodes stale; fit+spread scoring",
                )
            else:
                self._health.set(self._health_component, HealthState.HEALTHY)
        cb = self._on_transition
        if cb is not None:
            try:
                cb(active, fraction)
            except Exception:
                pass
