"""Deterministic, seeded chaos plans.

Counterpart of ``crane_scheduler_tpu/resilience/chaos.py`` (pure data,
stdlib only; the port keeps its own copy).

A ``ChaosPlan`` is a reproducible fault timeline: a sorted list of
``ChaosEvent``\\ s, each tagged with the simulation step at which it
fires. The plan itself is pure data — it knows nothing about the kube
or Prometheus stubs. The driver (``tests/test_torch_chaos.py``,
``chip_smoke.py``'s ``control`` phase) registers one *applier* callable
per event kind and calls ``apply(step, appliers)`` at each step
boundary.

Event kinds the harness understands (appliers may support a subset;
unknown kinds raise so a typo'd plan fails loudly):

- ``prom_outage`` / ``prom_heal``     — Prometheus hard down / back up
- ``prom_storm(count, status)``       — N responses of 429/5xx
- ``prom_slow(delay_s)``              — slow responses
- ``kube_read_storm(count, status)``  — LIST/GET fault burst
- ``kube_write_storm(count, status)`` — PATCH/POST fault burst
- ``kube_slow(delay_s)``              — slow apiserver responses
- ``torn_watch(count)``               — watch frames torn mid-line
- ``close_watches``                   — all watch streams dropped
- ``watch_410(after)``                — watch resumes answered 410 Gone
- ``skew_annotations(offset_s)``      — node stamps written clock-skewed
- ``request_storm(rate_x, duration)`` — open-loop serving storm at
  ``rate_x`` times baseline capacity for ``duration`` steps (the
  applier points at a ``StormSchedule``/load driver, not a stub)
- ``slow_client(count, stall_s)``     — slowloris: N connections that
  send a partial request then stall, pinning frontend conn slots

``ChaosPlan.generate(seed, ...)`` builds a randomized-but-reproducible
plan: every fault event is paired with a heal inside the horizon, so
any seed converges by construction and the invariants (no duplicate
binds/evictions, zero evictions while degraded, mirror converges after
heal) are checkable for all of them.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Tuple


@dataclass(frozen=True)
class ChaosEvent:
    at_step: int
    kind: str
    params: Tuple[Tuple[str, object], ...] = ()

    def param(self, name: str, default=None):
        for k, v in self.params:
            if k == name:
                return v
        return default

    @staticmethod
    def make(at_step: int, kind: str, **params) -> "ChaosEvent":
        return ChaosEvent(at_step, kind, tuple(sorted(params.items())))


# fault kinds generate() may emit, with their paired heal (None = the
# fault is a self-clearing burst and needs no heal event)
_FAULT_KINDS: Tuple[Tuple[str, object], ...] = (
    ("prom_outage", "prom_heal"),
    ("prom_storm", None),
    ("prom_slow", "prom_heal"),
    ("kube_read_storm", None),
    ("kube_write_storm", None),
    ("torn_watch", None),
    ("close_watches", None),
    ("watch_410", None),
    ("skew_annotations", None),
    # crash-safety: kill the scheduler process mid-write — the
    # param is a placement-intent-journal byte offset for the recovery
    # harness's KillSwitch (SIGKILL-at-offset), restart_process is the
    # paired heal (reconcile-then-reopen). Process-level, not a wire
    # fault: only emitted when the caller opts in via kinds=, so plans
    # generated for wire-stub drivers never require a kill applier.
    ("kill_process", "restart_process"),
    # overload: serving-plane faults — an open-loop request
    # storm and slowloris clients. Opt-in like kill_process: they need
    # a serving frontend to point at, which the wire-stub drivers for
    # the kube/prom kinds don't have.
    ("request_storm", "storm_heal"),
    ("slow_client", None),
)

_OPT_IN_KINDS = frozenset({"kill_process", "request_storm", "slow_client"})


@dataclass
class ChaosPlan:
    seed: int
    steps: int
    events: List[ChaosEvent] = field(default_factory=list)

    def add(self, at_step: int, kind: str, **params) -> "ChaosPlan":
        self.events.append(ChaosEvent.make(at_step, kind, **params))
        self.events.sort(key=lambda e: e.at_step)
        return self

    def events_at(self, step: int) -> List[ChaosEvent]:
        return [e for e in self.events if e.at_step == step]

    def apply(
        self,
        step: int,
        appliers: Mapping[str, Callable[[ChaosEvent], None]],
    ) -> List[ChaosEvent]:
        """Fire every event scheduled for ``step``. Returns those fired."""
        fired = self.events_at(step)
        for event in fired:
            applier = appliers.get(event.kind)
            if applier is None:
                raise KeyError(
                    f"no applier registered for chaos kind {event.kind!r}"
                )
            applier(event)
        return fired

    def last_fault_step(self) -> int:
        """Step of the last fault/heal event — recovery is measured from
        here (everything after is the heal window)."""
        return max((e.at_step for e in self.events), default=0)

    def describe(self) -> str:
        lines = [f"ChaosPlan(seed={self.seed}, steps={self.steps})"]
        for e in self.events:
            kv = " ".join(f"{k}={v}" for k, v in e.params)
            lines.append(f"  step {e.at_step:4d}: {e.kind} {kv}".rstrip())
        return "\n".join(lines)

    @staticmethod
    def generate(
        seed: int,
        steps: int = 60,
        n_faults: int = 4,
        kinds: Tuple[str, ...] | None = None,
        quiet_tail: int = 10,
    ) -> "ChaosPlan":
        """A reproducible random plan: ``n_faults`` faults in the first
        ``steps - quiet_tail`` steps, every heal-paired fault healed
        before the tail so the plan converges by construction."""
        rng = random.Random(seed)
        plan = ChaosPlan(seed=seed, steps=steps)
        fault_horizon = max(1, steps - quiet_tail)
        if kinds is not None:
            wanted = set(kinds)
        else:
            wanted = {k for k, _ in _FAULT_KINDS} - _OPT_IN_KINDS
        pool = [(k, heal) for k, heal in _FAULT_KINDS if k in wanted]
        if not pool:
            raise ValueError(f"no chaos kinds match {kinds!r}")
        for _ in range(n_faults):
            kind, heal = pool[rng.randrange(len(pool))]
            at = rng.randrange(0, fault_horizon)
            params: Dict[str, object] = {}
            if kind in ("prom_storm", "kube_read_storm", "kube_write_storm"):
                params["count"] = rng.randint(2, 8)
                params["status"] = rng.choice((429, 500, 502, 503))
            elif kind in ("prom_slow",):
                params["delay_s"] = round(rng.uniform(0.05, 0.3), 3)
            elif kind == "torn_watch":
                params["count"] = rng.randint(1, 4)
            elif kind == "watch_410":
                params["after"] = rng.randint(1, 3)
            elif kind == "skew_annotations":
                # skew far enough that stamps look expired to the oracle
                params["offset_s"] = rng.choice((-3600.0, -7200.0))
            elif kind == "request_storm":
                # rate multiplier vs. baseline capacity; duration in
                # steps (the paired storm_heal marks the calm point,
                # the burst itself ends after ``duration``)
                params["rate_x"] = rng.choice((2.0, 3.0, 5.0))
                params["duration"] = rng.randint(3, 10)
            elif kind == "slow_client":
                params["count"] = rng.randint(2, 8)
                params["stall_s"] = round(rng.uniform(1.0, 10.0), 3)
            elif kind == "kill_process":
                # absolute journal byte offset for the KillSwitch: any
                # offset is legal (the crash-safety contract is "kill at
                # ANY byte"), so sample widely across a small journal
                params["offset"] = rng.randrange(1, 4096)
            plan.add(at, kind, **params)
            if heal is not None:
                heal_at = rng.randrange(at + 1, fault_horizon + 1)
                plan.add(heal_at, heal)
        if any(e.kind == "skew_annotations" for e in plan.events):
            # skew is healed by the next honest annotation sweep; mark an
            # explicit heal point so recovery measurement has an anchor
            last = max(
                e.at_step
                for e in plan.events
                if e.kind == "skew_annotations"
            )
            plan.add(min(fault_horizon, last + 1), "skew_heal")
        return plan
