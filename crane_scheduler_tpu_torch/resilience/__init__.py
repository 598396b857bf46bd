"""Shared fault-domain resilience layer.

Counterpart of ``crane_scheduler_tpu/resilience/__init__.py``, with the
pieces the scoring sidecar, the annotator and the descheduler use:

- ``CircuitBreaker`` — closed/open/half-open over a sliding failure
  window, one instance per fault target (``device-dispatch`` for the
  sidecar's scorer);
- ``HealthRegistry`` — aggregates component states
  (healthy/degraded/failed, with reasons), served on ``/healthz`` and
  exported as ``crane_health_state{component}`` gauges;
- ``DegradedModeController`` — cluster-wide staleness tracker over the
  ``value,timestamp`` annotations with enter/exit hysteresis; while
  active the sidecar serves spread-only scores.

- ``RetryPolicy`` — full-jitter exponential backoff with per-call
  deadline budgets and ``Retry-After`` awareness (the Prometheus
  client's retries).

- ``loadgen`` — the serving plane's open-loop storm generator: a seeded
  ``StormSchedule`` (arrival timelines that do not negotiate with a
  slowing server), ``replay_admission`` for virtual-time deterministic
  replays of the admission state machine, ``run_open_loop`` for firing
  the same schedule on real sockets, and ``SlowClientSwarm`` as the
  slowloris injector the front end's idle reaper must defeat.

- ``chaos`` — the deterministic seeded ``ChaosPlan`` (pure data: the
  appliers that drive the kube and Prometheus stubs live with the
  drivers, ``tests/test_torch_chaos.py`` and ``chip_smoke.py``).

- ``recovery`` — the process's own death: the crash-safe
  placement-intent journal (``IntentJournal``), restart reconciliation
  (``Reconciler``) and the warm-standby failover coordinator
  (``WarmStandby``), with ``KillSwitch`` as the deterministic
  SIGKILL-at-offset injector.
"""

from .breaker import BreakerOpenError, BreakerState, CircuitBreaker
from .chaos import ChaosEvent, ChaosPlan
from .degraded import DegradedModeController
from .health import HealthRegistry, HealthState
from .loadgen import (
    Arrival,
    SlowClientSwarm,
    StormSchedule,
    VirtualClock,
    WireResult,
    replay_admission,
    run_open_loop,
    timeline_counts,
)
from .recovery import (
    IntentJournal,
    JournalReplay,
    KillSwitch,
    ReconcileReport,
    Reconciler,
    SimulatedCrash,
    WarmStandby,
    replay_journal,
)
from .retry import RetryBudgetExceeded, RetryPolicy

__all__ = [
    "Arrival",
    "BreakerOpenError",
    "BreakerState",
    "CircuitBreaker",
    "ChaosEvent",
    "ChaosPlan",
    "DegradedModeController",
    "HealthRegistry",
    "HealthState",
    "IntentJournal",
    "JournalReplay",
    "KillSwitch",
    "ReconcileReport",
    "Reconciler",
    "RetryBudgetExceeded",
    "RetryPolicy",
    "SimulatedCrash",
    "SlowClientSwarm",
    "StormSchedule",
    "VirtualClock",
    "WarmStandby",
    "WireResult",
    "replay_admission",
    "replay_journal",
    "run_open_loop",
    "timeline_counts",
]
