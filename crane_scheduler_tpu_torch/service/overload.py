"""Adaptive admission control and brownout tiers for the serving path.

Copy of ``crane_scheduler_tpu/service/overload.py``.

An open-loop request storm does not negotiate: work arrives at a rate
the worker pool cannot absorb, queues grow without bound, and p99
blows up for *everyone* — congestion collapse. The cure is deciding
early, on the IO thread, what not to serve (Agon, arxiv 2109.00665):

- ``TokenBucket`` — per-tenant rate limits; a tenant over its rate is
  answered 429 + Retry-After before a worker is dispatched;
- ``GradientLimiter`` — an AIMD/gradient concurrency limit keyed on
  observed vs. baseline latency (Netflix gradient style): when served
  latency inflates against the no-load baseline the limit multiplies
  down, when latency is healthy it creeps up. The pool size caps it;
  the limiter's job is to keep queueing OUT of the pool;
- ``TenantQueues`` — bounded per-tenant FIFO queues of ready
  connections with smooth-weighted-round-robin dequeue, so one noisy
  tenant cannot starve the rest while slots are contended;
- ``AdmissionController`` — the IO-thread front door tying the above
  together: classify (deadline / rate / priority) at parse, acquire or
  queue at job dispatch, weighted-fair handoff at job finish;
- ``BrownoutController`` — graceful degradation BEFORE shedding:
  pressure-driven tiers with enter/exit hysteresis. Tier 1 lets the
  scoring service serve the version-keyed pre-rendered response cache
  at a relaxed staleness bound (stale beats shed); tier 2 additionally
  sheds background-priority work at admission. Tier state is exported
  (``crane_service_brownout_tier``) and mirrored into the
  ``HealthRegistry`` as the ``overload`` component.

Every decision is counted in ``crane_service_shed_total{reason}`` and
shed requests never touch the accepted-request LatencyRing, so p99
reflects traffic actually served. Deterministic under test: clocks are
injectable and nothing here consults a RNG. Stdlib-only.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque

from . import deadline as _deadline

# endpoints that are never admission-gated: probes and scrapes must
# stay green precisely when the service is saturated
EXEMPT_TARGETS = ("/healthz", "/metrics")

TENANT_HEADER = "crane-tenant"
PRIORITY_HEADER = "crane-priority"
DEFAULT_TENANT = "default"

_LOW_PRIORITY_NAMES = frozenset({"low", "background", "batch"})


def request_tenant(headers) -> str:
    t = headers.get(TENANT_HEADER) if headers else None
    return t.strip() if t and t.strip() else DEFAULT_TENANT


def request_is_low_priority(headers) -> bool:
    """``crane-priority``: a name (low/background/batch) or an integer
    where >= 2 means sheddable. Absent or malformed => normal."""
    v = headers.get(PRIORITY_HEADER) if headers else None
    if not v:
        return False
    v = v.strip().lower()
    if v in _LOW_PRIORITY_NAMES:
        return True
    try:
        return int(v) >= 2
    except ValueError:
        return False


class TokenBucket:
    """Classic token bucket; ``rate`` tokens/s up to ``burst``. A rate
    of 0 means unlimited (the bucket always grants)."""

    __slots__ = ("rate", "burst", "_tokens", "_last")

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self._tokens = self.burst
        self._last = None

    def _refill(self, now: float) -> None:
        if self._last is not None and now > self._last:
            self._tokens = min(
                self.burst, self._tokens + (now - self._last) * self.rate
            )
        self._last = now

    def try_take(self, now: float) -> bool:
        if self.rate <= 0:
            return True
        self._refill(now)
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False

    def retry_after_s(self, now: float) -> float:
        """Time until one token exists (the 429 Retry-After value)."""
        if self.rate <= 0:
            return 0.0
        self._refill(now)
        deficit = 1.0 - self._tokens
        return max(0.0, deficit / self.rate)


class GradientLimiter:
    """AIMD/gradient concurrency limit from observed latency.

    ``baseline`` tracks the no-load latency (min-biased EWMA: snaps
    down to any faster sample, drifts up slowly so a genuinely slower
    regime eventually becomes the new baseline). ``short`` tracks
    recent latency. When short inflates past ``tolerance * baseline``
    the limit multiplies down toward the gradient; otherwise a sqrt
    queue allowance lets it creep up. Deterministic: pure function of
    the observed latency sequence."""

    def __init__(
        self,
        *,
        min_limit: int = 1,
        max_limit: int = 64,
        initial: int | None = None,
        tolerance: float = 2.0,
        smoothing: float = 0.2,
    ):
        if not (0 < min_limit <= max_limit):
            raise ValueError("need 0 < min_limit <= max_limit")
        self.min_limit = int(min_limit)
        self.max_limit = int(max_limit)
        self.tolerance = float(tolerance)
        self.smoothing = float(smoothing)
        self._limit = float(initial if initial is not None else max_limit)
        self._limit = min(max(self._limit, min_limit), max_limit)
        self._baseline: float | None = None
        self._short: float | None = None

    @property
    def limit(self) -> int:
        return int(self._limit)

    @property
    def baseline_s(self) -> float | None:
        return self._baseline

    def observe(self, latency_s: float) -> None:
        if latency_s <= 0:
            return
        if self._short is None:
            self._short = latency_s
            self._baseline = latency_s
            return
        self._short += 0.2 * (latency_s - self._short)
        if latency_s < self._baseline:
            self._baseline = latency_s
        else:
            # slow upward drift: a durably slower service re-baselines
            # instead of pinning the limit at min forever
            self._baseline += 0.02 * (latency_s - self._baseline)
        gradient = self.tolerance * self._baseline / self._short
        gradient = min(1.0, max(0.5, gradient))
        target = self._limit * gradient + math.sqrt(self._limit)
        self._limit += self.smoothing * (target - self._limit)
        self._limit = min(max(self._limit, self.min_limit), self.max_limit)


class TenantQueues:
    """Bounded per-tenant FIFO queues with smooth weighted round-robin
    dequeue (the nginx SWRR scheme: deterministic, no starvation, a
    weight-2 tenant drains twice as often as a weight-1 one)."""

    def __init__(self, *, depth: int = 64, weights: dict | None = None):
        self.depth = max(1, int(depth))
        self._weights = dict(weights or {})
        self._queues: dict[str, deque] = {}
        self._credit: dict[str, float] = {}

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def weight(self, tenant: str) -> float:
        return max(0.1, float(self._weights.get(tenant, 1.0)))

    def push(self, tenant: str, item) -> bool:
        q = self._queues.get(tenant)
        if q is None:
            q = self._queues[tenant] = deque()
            self._credit.setdefault(tenant, 0.0)
        if len(q) >= self.depth:
            return False
        q.append(item)
        return True

    def pop(self):
        """The next item, weighted-fair across non-empty tenants."""
        busy = [(t, q) for t, q in self._queues.items() if q]
        if not busy:
            return None
        total = 0.0
        best = None
        for t, _ in busy:
            w = self.weight(t)
            self._credit[t] = self._credit.get(t, 0.0) + w
            total += w
            if best is None or self._credit[t] > self._credit[best]:
                best = t
        self._credit[best] -= total
        return self._queues[best].popleft()


class ShedDecision:
    """An IO-thread verdict: answer ``status`` with ``reason`` (and a
    Retry-After when > 0) instead of dispatching a worker."""

    __slots__ = ("status", "reason", "retry_after_s")

    def __init__(self, status: int, reason: str, retry_after_s: float = 0.0):
        self.status = status
        self.reason = reason
        self.retry_after_s = retry_after_s

    def __repr__(self):
        return (f"ShedDecision({self.status}, {self.reason!r}, "
                f"retry_after={self.retry_after_s:.3f}s)")


class AdmissionController:
    """The IO-thread front door. Thread-safe; one instance per server.

    Flow: ``classify`` at parse (deadline / token bucket / priority →
    a ``ShedDecision`` or None = admit), ``acquire`` at job dispatch
    (inflight slot under the gradient limit, else ``queue``), and
    ``finish``/``abandon`` at job end (weighted-fair handoff of a
    queued connection into the freed slot)."""

    def __init__(
        self,
        *,
        limiter: GradientLimiter | None = None,
        queues: TenantQueues | None = None,
        tenant_rate: float = 0.0,
        tenant_burst: float = 10.0,
        tenant_rates: dict | None = None,
        retry_after_s: float = 1.0,
        brownout: "BrownoutController | None" = None,
        telemetry=None,
        clock=time.monotonic,
    ):
        self.limiter = limiter if limiter is not None else GradientLimiter()
        self.queues = queues if queues is not None else TenantQueues()
        self.default_rate = float(tenant_rate)
        self.default_burst = float(tenant_burst)
        self._rates = dict(tenant_rates or {})
        self.retry_after_s = float(retry_after_s)
        self.brownout = brownout
        self._clock = clock
        self._lock = threading.Lock()
        self._inflight = 0
        self._buckets: dict[str, TokenBucket] = {}
        self.stats = {
            "admitted": 0, "queued": 0, "shed": 0, "observed": 0,
        }
        self._m_shed = None
        if telemetry is not None:
            reg = telemetry.registry
            self._m_shed = reg.counter(
                "crane_service_shed_total",
                "Requests shed before serving, by reason",
                labelnames=("reason",),
            )
            self._m_inflight = reg.gauge(
                "crane_service_admission_inflight",
                "Handler jobs currently holding an admission slot",
            )
            self._m_queued = reg.gauge(
                "crane_service_admission_queued",
                "Connections parked in the per-tenant admission queues",
            )
            self._m_limit = reg.gauge(
                "crane_service_admission_limit",
                "Current adaptive concurrency limit",
            )
            self._m_limit.set(self.limiter.limit)

    # -- bookkeeping --------------------------------------------------------

    def _bucket(self, tenant: str) -> TokenBucket:
        b = self._buckets.get(tenant)
        if b is None:
            rate = float(self._rates.get(tenant, self.default_rate))
            b = self._buckets[tenant] = TokenBucket(rate, self.default_burst)
        return b

    def count_shed(self, reason: str) -> None:
        with self._lock:
            self.stats["shed"] += 1
        if self._m_shed is not None:
            self._m_shed.labels(reason=reason).inc()

    def pressure(self) -> float:
        """Demand over capacity: (inflight + queued) / limit. ~<=1 when
        healthy; the brownout tiers key on it."""
        with self._lock:
            limit = max(1, self.limiter.limit)
            return (self._inflight + len(self.queues)) / limit

    def _note_brownout(self) -> None:
        if self.brownout is not None:
            self.brownout.note(self.pressure(), now=self._clock())

    # -- parse-time classification (IO thread) ------------------------------

    def classify(self, method, target, headers, now=None) -> ShedDecision | None:
        """Shed-or-admit for one parsed request. Mutates ``headers`` to
        anchor the deadline (see ``deadline.anchor_headers``). Returns
        None to admit."""
        path, _, _ = target.partition("?")
        if path in EXEMPT_TARGETS:
            return None
        if now is None:
            now = self._clock()
        dl = _deadline.anchor_headers(headers, now)
        if dl is not None and dl.expired(now):
            return ShedDecision(504, "deadline_parse")
        tenant = request_tenant(headers)
        with self._lock:
            bucket = self._bucket(tenant)
            if not bucket.try_take(now):
                retry = max(self.retry_after_s, bucket.retry_after_s(now))
                decision = ShedDecision(429, "rate_limit", retry)
            elif (
                self.brownout is not None
                and self.brownout.tier >= 2
                and request_is_low_priority(headers)
            ):
                decision = ShedDecision(503, "priority", self.retry_after_s)
            else:
                decision = None
                self.stats["admitted"] += 1
        self._note_brownout()
        return decision

    # -- job-slot accounting ------------------------------------------------

    def acquire(self) -> bool:
        """Take an inflight slot if one exists under the current limit."""
        with self._lock:
            if self._inflight < self.limiter.limit:
                self._inflight += 1
                granted = True
            else:
                granted = False
            if self._m_shed is not None:
                self._m_inflight.set(self._inflight)
        return granted

    def queue(self, tenant: str, item) -> bool:
        """Park a ready connection awaiting a slot. False = queue full
        (the caller sheds with 503 + Retry-After)."""
        with self._lock:
            ok = self.queues.push(tenant, item)
            if ok:
                self.stats["queued"] += 1
            if self._m_shed is not None:
                self._m_queued.set(len(self.queues))
        self._note_brownout()
        return ok

    def _release_and_pop(self):
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            item = None
            if self._inflight < self.limiter.limit:
                item = self.queues.pop()
                if item is not None:
                    self._inflight += 1
            if self._m_shed is not None:
                self._m_inflight.set(self._inflight)
                self._m_queued.set(len(self.queues))
        return item

    def finish(self):
        """A job released its slot; returns a queued connection now
        owed that slot (weighted-fair), or None."""
        item = self._release_and_pop()
        self._note_brownout()
        return item

    def abandon(self):
        """The connection ``finish``/``abandon`` handed out turned out
        dead — give its slot to the next queued one."""
        return self._release_and_pop()

    # -- latency feedback ---------------------------------------------------

    def observe(self, latency_s: float) -> None:
        """Feed one accepted-request latency into the gradient limit."""
        with self._lock:
            self.stats["observed"] += 1
            self.limiter.observe(latency_s)
            if self._m_shed is not None:
                self._m_limit.set(self.limiter.limit)


class BrownoutController:
    """Pressure-driven degradation tiers with enter/exit hysteresis.

    - tier 0 — healthy;
    - tier 1 — brownout: the scoring service may serve its newest
      pre-rendered response at a relaxed staleness bound
      (``stale_budget_s``) instead of refreshing + dispatching;
    - tier 2 — shed: additionally, background-priority requests are
      shed at admission (503 + Retry-After).

    A cluster-wide ``DegradedModeController`` floors the tier at 1:
    when every annotation is stale anyway, serving the cached render is
    already the honest answer. Enter thresholds are strictly above exit
    thresholds so a service hovering at the boundary doesn't flap."""

    def __init__(
        self,
        *,
        enter1: float = 1.2,
        exit1: float = 0.8,
        enter2: float = 3.0,
        exit2: float = 1.5,
        stale_budget_s: float = 30.0,
        degraded=None,
        telemetry=None,
        health=None,
        health_component: str = "overload",
    ):
        if not (exit1 < enter1 <= exit2 < enter2):
            raise ValueError(
                "need exit1 < enter1 <= exit2 < enter2, got "
                f"{exit1}/{enter1}/{exit2}/{enter2}"
            )
        self.enter1, self.exit1 = float(enter1), float(exit1)
        self.enter2, self.exit2 = float(enter2), float(exit2)
        self.stale_budget_s = float(stale_budget_s)
        self.degraded = degraded
        self._health = health
        self._health_component = health_component
        self._lock = threading.Lock()
        self._tier = 0
        self._pressure = 0.0
        self._m_tier = None
        if telemetry is not None:
            reg = telemetry.registry
            self._m_tier = reg.gauge(
                "crane_service_brownout_tier",
                "Brownout tier (0 healthy, 1 serve-stale, 2 shed)",
            )
            self._m_transitions = reg.counter(
                "crane_service_brownout_transitions_total",
                "Brownout tier transitions", labelnames=("to",),
            )
            self._m_tier.set(0)

    @property
    def tier(self) -> int:
        with self._lock:
            tier = self._tier
        if tier < 1 and self.degraded is not None and self.degraded.active:
            return 1
        return tier

    @property
    def pressure(self) -> float:
        with self._lock:
            return self._pressure

    def note(self, pressure: float, now: float | None = None) -> int:
        """Fold one pressure sample into the tier state machine."""
        with self._lock:
            self._pressure = pressure
            tier = self._tier
            if tier < 2 and pressure > self.enter2:
                tier = 2
            elif tier < 1 and pressure > self.enter1:
                tier = 1
            elif tier == 2 and pressure < self.exit2:
                tier = 1 if pressure > self.exit1 else 0
            elif tier == 1 and pressure < self.exit1:
                tier = 0
            if tier != self._tier:
                self._set_tier(tier, pressure)
            return self._tier

    def _set_tier(self, tier: int, pressure: float) -> None:
        # caller holds self._lock
        self._tier = tier
        if self._m_tier is not None:
            self._m_tier.set(tier)
            self._m_transitions.labels(to=str(tier)).inc()
        if self._health is not None:
            from ..resilience.health import HealthState

            if tier == 0:
                self._health.set(self._health_component, HealthState.HEALTHY)
            else:
                self._health.set(
                    self._health_component,
                    HealthState.DEGRADED,
                    f"brownout tier {tier} (pressure {pressure:.2f})",
                )
