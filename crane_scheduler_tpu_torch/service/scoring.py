"""The scoring sidecar: batch scores in, verdicts out.

Counterpart of ``crane_scheduler_tpu/service/scoring.py``, on PyTorch.
The scorer is ``BatchedScorer(dtype)``: float64 is plain PyTorch,
float32 launches the fused kernel ``csrc/score_kernel.cu`` on CUDA
tensors. The reference's ``backend`` switch (``"xla"`` / ``"pallas"``)
has no counterpart: both of its choices are that one float32 scorer
here. The device path is ``_score_device`` (``_score_tpu`` in the
reference), and the body's ``"backend"`` names the scorer's device type
(``"cuda"``, or ``"cpu"`` when the service was built with
``device="cpu"``) where the reference says ``"tpu"``. ``assign_batch``
runs the water-filling ``GangScheduler`` on the same device; its dense
level totals launch ``csrc/gang_totals.cu``.

The deployment keeps the scheduler-framework plugin boundary and ships
per-node load vectors to a device process. This service is that
boundary: it owns the load store and the scorer, and exposes
``score_batch``. Its contract mirrors the reference's:

- **fail-open on the CPU only**: a service built with ``device="cpu"``
  answers from the scalar oracle (and ``assign_batch`` from the numpy
  host solver) when its tensor path raises, as the reference does. On
  the card a failed build or launch is an error the caller sees (a 500
  on the HTTP surface), never an oracle answer that hides the card;
- staleness is data, not liveness: a dead annotator degrades scores to 0
  within the policy windows without blocking scheduling;
- counters expose scorer latency/staleness/fallbacks — the observability
  the reference lacks (it exports no metrics endpoint at all).

Serving discipline: the scorer's output is a pure
function of (store version, policy, ``now``), so concurrent requests
that agree on that key legitimately share one device dispatch and one
rendered response byte-string:

- **single-flight refresh** — the default per-request ``refresh`` is
  version-gated on the cluster's ``node_version`` and deduped, so a
  request storm costs one ``bulk_ingest`` per cluster change, not one
  per request;
- **coalesced dispatch** — concurrent ``/v1/score`` requests with the
  same (store version, last refresh, ``now`` bucket) collapse onto one
  in-flight ``score_batch`` whose result every waiter shares;
- **version-keyed response cache** — the response body is rendered to
  bytes once per key (vectorized ``tolist()`` render, no per-node
  Python loop) and served as a memcpy until a store write changes the
  version;
- **lock split** — scoring reads a store snapshot (the store's own
  lock); the service lock only serializes store mutation (refresh), so
  a slow refresh never blocks an in-flight score.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..cluster.state import ClusterState
from ..constants import MAX_NODE_SCORE, MIN_NODE_SCORE
from ..device import resolve_device
from ..policy.compile import compile_policy
from ..policy.types import DynamicSchedulerPolicy
from ..loadstore.store import NodeLoadStore
from ..resilience.breaker import BreakerOpenError
from . import deadline as _deadline
from ..scorer import oracle
from ..scorer.batched import BatchedScorer
from ..telemetry import Telemetry


class LatencyRing:
    """Fixed-size latency ring: O(1) record, no list growth/`del`-slice
    churn under the hot lock (callers provide their own locking)."""

    __slots__ = ("_buf", "_idx", "_count")

    def __init__(self, capacity: int = 2048):
        self._buf = np.zeros(max(int(capacity), 1), dtype=np.float64)
        self._idx = 0
        self._count = 0

    def record(self, value: float) -> None:
        buf = self._buf
        buf[self._idx] = value
        self._idx = (self._idx + 1) % len(buf)
        if self._count < len(buf):
            self._count += 1

    def __len__(self) -> int:
        return self._count

    def percentiles(self, *qs: float) -> tuple[float, ...]:
        """Percentiles over the retained window (0.0 when empty)."""
        if not self._count:
            return tuple(0.0 for _ in qs)
        window = self._buf[: self._count]
        return tuple(float(v) for v in np.percentile(window, qs))


class _Flight:
    __slots__ = ("event", "result", "exc")

    def __init__(self):
        self.event = threading.Event()
        self.result = None
        self.exc = None


class _SingleFlight:
    """Duplicate-call suppression: concurrent calls with the same key
    share the leader's result (errors propagate to every waiter)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._flights: dict = {}

    def run(self, key, fn):
        """Returns ``(result, leader)``; ``leader`` is False for calls
        that waited on another caller's in-flight computation."""
        with self._lock:
            flight = self._flights.get(key)
            if flight is None:
                flight = _Flight()
                self._flights[key] = flight
                leader = True
            else:
                leader = False
        if not leader:
            flight.event.wait()
            if flight.exc is not None:
                raise flight.exc
            return flight.result, False
        try:
            flight.result = fn()
        except BaseException as e:
            flight.exc = e
            raise
        finally:
            with self._lock:
                self._flights.pop(key, None)
            flight.event.set()
        return flight.result, True


class _ResponseCache:
    """Tiny thread-safe LRU for rendered response bodies. Keys embed the
    store version, so stale entries can never hit — the cap only bounds
    memory across ``now`` buckets.

    ``latest()`` is the brownout escape hatch: the newest
    rendered body regardless of key, as long as it is younger than the
    caller's relaxed staleness budget — under overload a slightly stale
    answer beats a shed one.

    The staleness clock is INJECTED (``mono_clock``, default
    ``time.monotonic``): the brownout budget is an elapsed-time bound,
    and an NTP step on the wall clock must not be able to serve an
    over-stale body or prematurely expire a fresh one. Tests inject a
    fake monotonic clock to prove it."""

    def __init__(self, capacity: int = 16, mono_clock=time.monotonic):
        self._capacity = capacity
        self._mono = mono_clock
        self._lock = threading.Lock()
        self._entries: dict = {}
        self._latest: tuple[bytes, float] | None = None  # (body, mono_at)

    def get(self, key):
        with self._lock:
            body = self._entries.get(key)
            if body is not None:
                # move-to-back = most recently used
                del self._entries[key]
                self._entries[key] = body
            return body

    def put(self, key, body: bytes) -> None:
        with self._lock:
            self._entries.pop(key, None)
            self._entries[key] = body
            self._latest = (body, self._mono())
            while len(self._entries) > self._capacity:
                self._entries.pop(next(iter(self._entries)))

    def latest(self, max_age_s: float) -> bytes | None:
        """The most recently rendered body if it is at most
        ``max_age_s`` old (the injected monotonic clock), else None."""
        with self._lock:
            if self._latest is None:
                return None
            body, at = self._latest
        if self._mono() - at > max_age_s:
            return None
        return body

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._latest = None

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


@dataclass
class ServiceStats:
    refreshes: int = 0
    refresh_skips: int = 0  # version-gated / single-flight-deduped
    score_calls: int = 0
    coalesced_scores: int = 0  # requests served by another's dispatch
    response_cache_hits: int = 0
    fallbacks: int = 0
    brownout_served: int = 0  # stale renders served under brownout
    expired_at_dispatch: int = 0  # invariant counter: must stay 0
    last_refresh_at: float = 0.0
    last_score_seconds: float = 0.0
    score_seconds_total: float = 0.0
    latencies: LatencyRing = field(default_factory=LatencyRing)


@dataclass
class BatchVerdicts:
    schedulable: dict  # node -> bool
    scores: dict  # node -> int
    # the device type ("cuda" | "cpu"), "oracle-fallback" or "degraded-spread"
    backend: str
    staleness_seconds: float
    store_version: int = -1  # store version of the scored snapshot


@dataclass
class BatchAssignment:
    counts: dict  # node -> pods assigned (zero-count nodes omitted)
    unassigned: int
    waterline: int
    backend: str  # scorer backend, or "host-fallback" if the solver fell back
    staleness_seconds: float


class ScoringService:
    def __init__(
        self,
        cluster: ClusterState,
        policy: DynamicSchedulerPolicy,
        dtype=torch.float64,
        device=None,
        clock=time.time,
        snapshot_bucket: int = 2048,
        telemetry: Telemetry | None = None,
        now_bucket_s: float = 0.25,
        device_breaker=None,
        degraded=None,
        mono_clock=time.monotonic,
        version_source=None,
    ):
        self.cluster = cluster
        self.policy = policy
        # None means the GPU, and raises without one
        self.device = resolve_device(device)
        # breaker over the device dispatch — while open, score_batch
        # does not touch the device (the oracle answers on the CPU, the
        # call raises BreakerOpenError on the card); half-open probes
        # let a recovered device win back the traffic
        self.device_breaker = device_breaker
        # cluster-wide staleness tracker; refresh() re-evaluates it and
        # while degraded the service serves annotation-free spread scores
        self.degraded = degraded
        self.tensors = compile_policy(policy)
        self.store = NodeLoadStore(self.tensors)
        self.scorer = BatchedScorer(self.tensors, dtype, self.device)
        # what a device-path body says in "backend"; only such renders
        # enter the response cache
        self.device_backend = self.device.type
        self.stats = ServiceStats()
        self._bucket = snapshot_bucket
        self._clock = clock
        # lock split: `_lock` serializes STORE MUTATION (refresh) only;
        # counters ride `_stats_lock`; scoring reads a store snapshot
        # and holds neither across the device dispatch
        self._lock = threading.RLock()
        self._stats_lock = threading.Lock()
        # requests with no explicit `now` score at the floor of this
        # bucket: the coalescing/caching key quantum (0 = no bucketing)
        self.now_bucket_s = now_bucket_s
        self._score_flight = _SingleFlight()
        self._refresh_flight = _SingleFlight()
        self._resp_cache = _ResponseCache(mono_clock=mono_clock)
        # replica mode: when set, ``version_source()`` is the
        # mirror's applied version fence and responses render
        # DETERMINISTICALLY — version-stamped, sorted keys, no local
        # wall-clock staleness — so two replicas at the same
        # (applied_version, store.version, now) produce byte-identical
        # bodies regardless of when each one refreshed.
        self._version_source = version_source
        # cluster node_version the store last ingested (None = never):
        # the single-flight refresh's version gate
        self._refreshed_cluster_version = None
        # the service IS the /metrics surface, so it always carries a
        # registry (unlike hot-path modules, which gate on None); the
        # legacy JSON counters in ``stats`` stay authoritative for the
        # back-compat payload, the registry for the exposition format
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        reg = self.telemetry.registry
        self._m_refreshes = reg.counter(
            "crane_scoring_refreshes_total", "Store refreshes served"
        )
        self._m_score_calls = reg.counter(
            "crane_scoring_score_calls_total", "score_batch calls"
        )
        self._m_fallbacks = reg.counter(
            "crane_scoring_fallbacks_total",
            "Fail-open falls to the scalar oracle / host solver",
        )
        self._m_score_seconds = reg.histogram(
            "crane_scoring_score_seconds", "score_batch latency"
        )
        self._m_staleness = reg.gauge(
            "crane_scoring_staleness_seconds",
            "Age of the store data at the last score call (-1 = never "
            "refreshed)",
        )
        self._m_nodes = reg.gauge(
            "crane_scoring_nodes", "Rows in the columnar load store"
        )
        self._m_assign_calls = reg.counter(
            "crane_scoring_assign_calls_total", "assign_batch calls"
        )
        self._m_coalesced = reg.counter(
            "crane_service_coalesced_total",
            "Requests that shared another request's in-flight work "
            "(kind=score: device dispatch; kind=refresh: bulk ingest, "
            "including version-gated skips)",
            labelnames=("kind",),
        )
        self._m_resp_cache_hits = reg.counter(
            "crane_service_response_cache_hits_total",
            "Score responses served as pre-rendered bytes",
        )
        self._m_degraded_scores = reg.counter(
            "crane_scoring_degraded_scores_total",
            "score_batch calls served spread-only in degraded mode",
        )
        # overload protection: brownout serve-stale + the
        # zero-expired-dispatch invariant. ``brownout`` is assigned by
        # the server wiring (ScoringHTTPServer / service_main).
        self.brownout = None
        self._m_brownout_served = reg.counter(
            "crane_service_brownout_served_total",
            "Score responses served from the newest pre-rendered body "
            "at relaxed staleness under brownout",
        )
        self._m_expired_dispatch = reg.counter(
            "crane_scoring_expired_at_dispatch_total",
            "Requests whose deadline was already expired when the "
            "device dispatch started (invariant: stays 0 — expired "
            "requests are shed at earlier checkpoints)",
        )

    # -- refresh -----------------------------------------------------------

    def _cluster_version(self):
        """The narrowest cluster counter a node-annotation consumer can
        key on (``node_version``; ``sched_version`` fallback)."""
        v = getattr(self.cluster, "node_version", None)
        if v is None:
            v = getattr(self.cluster, "sched_version", None)
        return v

    def refresh(self) -> None:
        """Bulk re-read of node annotations into the columnar store
        (forced: always runs; the HTTP path goes through
        ``refresh_coalesced``)."""
        cv = self._cluster_version()
        with self._lock, self.telemetry.spans.span("refresh"):
            nodes = self.cluster.list_nodes()
            if self.degraded is not None:
                self.degraded.update(
                    (n.annotations for n in nodes), self._clock()
                )
            self.store.bulk_ingest((n.name, n.annotations) for n in nodes)
            self.store.prune_absent(n.name for n in nodes)
            with self._stats_lock:
                self.stats.refreshes += 1
                self.stats.last_refresh_at = self._clock()
            self._m_refreshes.inc()
            self._m_nodes.set(len(self.store))
            self._refreshed_cluster_version = cv

    def refresh_coalesced(self) -> bool:
        """The request-path refresh: version-gated and single-flight.

        A storm of default-``refresh`` requests costs ONE ``bulk_ingest``
        per cluster ``node_version`` change — callers that arrive while
        one is in flight wait for it; callers whose observed cluster
        version already matches the last ingest skip entirely. Returns
        True when this call actually ran the ingest."""
        cv = self._cluster_version()
        if (
            cv is not None
            and cv == self._refreshed_cluster_version
            and self.stats.last_refresh_at
        ):
            with self._stats_lock:
                self.stats.refresh_skips += 1
            self._m_coalesced.labels(kind="refresh").inc()
            return False
        _, leader = self._refresh_flight.run(("refresh", cv), self.refresh)
        if not leader:
            with self._stats_lock:
                self.stats.refresh_skips += 1
            self._m_coalesced.labels(kind="refresh").inc()
        return leader

    # -- scoring -----------------------------------------------------------

    @property
    def fail_open(self) -> bool:
        """Whether a failed tensor path falls back to the scalar oracle
        and the host solver: only on the CPU. On the card the failure
        propagates, so a kernel that does not build or launch cannot
        hide behind oracle answers."""
        return self.device.type == "cpu"

    def score_batch(self, now: float | None = None) -> BatchVerdicts:
        """Score every node. On the CPU a failed tensor path falls back
        to the oracle; on the card it raises (``fail_open``). An expired
        request deadline aborts BEFORE any scoring work — wasting a
        device round-trip on an answer nobody is waiting for is the
        failure mode overload protection exists to prevent."""
        _deadline.check("dispatch")
        if now is None:
            now = self._clock()
        start = time.perf_counter()
        self._m_score_calls.inc()
        with self._stats_lock:
            self.stats.score_calls += 1
            staleness = (
                now - self.stats.last_refresh_at
                if self.stats.last_refresh_at
                else -1.0
            )
        self._m_staleness.set(staleness)
        if self.degraded is not None and self.degraded.active:
            # one explicit mode transition instead of per-node neutral
            # drift: every annotation the scorer would read is stale
            verdicts = self._score_spread(now)
            self._m_degraded_scores.inc()
        else:
            breaker = self.device_breaker
            admitted = breaker is None or breaker.allow()
            try:
                if not admitted:
                    raise BreakerOpenError(breaker.target)
                with self.telemetry.spans.span("score_batch"):
                    verdicts = self._score_device(now)
                if breaker is not None:
                    breaker.record_success()
            except Exception:
                if breaker is not None and admitted:
                    breaker.record_failure()
                if not self.fail_open:
                    raise
                self._m_fallbacks.inc()
                with self._stats_lock:
                    self.stats.fallbacks += 1
                verdicts = self._score_oracle(now)
        elapsed = time.perf_counter() - start
        self._m_score_seconds.observe(elapsed)
        with self._stats_lock:
            self.stats.last_score_seconds = elapsed
            self.stats.score_seconds_total += elapsed
            self.stats.latencies.record(elapsed)
        verdicts.staleness_seconds = staleness
        return verdicts

    def _score_device(self, now: float) -> BatchVerdicts:
        """The device path (``_score_tpu`` in the reference): one
        snapshot, one scorer call, one copy to the host per array."""
        dl = _deadline.current()
        if dl is not None and dl.expired():
            # should be unreachable (earlier checkpoints shed first);
            # counted, not raised, so the invariant is observable
            self._m_expired_dispatch.inc()
            with self._stats_lock:
                self.stats.expired_at_dispatch += 1
        snap = self.store.snapshot(bucket=self._bucket)
        res = self.scorer(
            snap.values, snap.ts, snap.hot_value, snap.hot_ts, snap.node_valid, now
        )
        n = snap.n_nodes
        # vectorized render: one tolist() per array yields plain Python
        # bools/ints (the per-node bool()/int() loop this replaces was
        # ~half the request cost at 50k nodes)
        schedulable = res.schedulable[:n].cpu().numpy().astype(bool).tolist()
        scores = res.scores[:n].cpu().numpy().astype(np.int64).tolist()
        return BatchVerdicts(
            schedulable=dict(zip(snap.node_names, schedulable)),
            scores=dict(zip(snap.node_names, scores)),
            backend=self.device_backend,
            staleness_seconds=0.0,
            store_version=snap.version,
        )

    def _score_oracle(self, now: float) -> BatchVerdicts:
        """The in-process scalar path (ref semantics, always available)."""
        schedulable: dict[str, bool] = {}
        scores: dict[str, int] = {}
        for node in self.cluster.list_nodes():
            anno = dict(node.annotations or {})
            ok, _ = oracle.filter_node(anno, self.policy.spec, now)
            schedulable[node.name] = ok
            scores[node.name] = oracle.score_node(anno, self.policy.spec, now)
        return BatchVerdicts(
            schedulable=schedulable,
            scores=scores,
            backend="oracle-fallback",
            staleness_seconds=0.0,
        )

    def _score_spread(self, now: float) -> BatchVerdicts:
        """Degraded-mode verdicts: every node schedulable (ResourceFit
        still guards capacity on the consumer side), fewest pods wins —
        no annotation is consulted. Mirrors ``plugins.dynamic``'s
        degraded path so drip and batch agree on the fallback policy."""
        schedulable: dict[str, bool] = {}
        scores: dict[str, int] = {}
        list_pods = getattr(self.cluster, "list_pods", None)
        for node in self.cluster.list_nodes():
            schedulable[node.name] = True
            npods = len(list_pods(node.name)) if callable(list_pods) else 0
            scores[node.name] = max(MIN_NODE_SCORE, MAX_NODE_SCORE - npods)
        return BatchVerdicts(
            schedulable=schedulable,
            scores=scores,
            backend="degraded-spread",
            staleness_seconds=0.0,
        )

    # -- rendered responses ------------------------------------------------

    def _resolve_now(self, now: float | None) -> float:
        """An explicit ``now`` is used verbatim; otherwise the wall
        clock floors to ``now_bucket_s`` so concurrent requests agree
        on the coalescing key."""
        if now is not None:
            return float(now)
        t = self._clock()
        b = self.now_bucket_s
        return int(t / b) * b if b > 0 else t

    def score_response_bytes(
        self, now: float | None = None, refresh: bool = True
    ) -> bytes:
        """The rendered ``/v1/score`` response body: coalesced,
        version-keyed, served as a memcpy on repeat.

        Cache/coalescing key: (store version, last refresh time, ``now``)
        — the exact inputs the rendered bytes are a pure function of
        (policy is fixed per service). Any store write bumps the version,
        so stale bytes can never be served across a write; any refresh
        moves ``last_refresh_at``, so the reported staleness re-renders.
        Fallback renders are shared with concurrent waiters but never
        cached (a recovered device must win the next request)."""
        bo = self.brownout
        if bo is not None and bo.tier >= 1:
            # brownout: the newest pre-rendered body at the relaxed
            # staleness bound beats a refresh + dispatch — and far
            # beats a shed. A cold cache falls through to the normal
            # path (tier 1 still serves; it just serves fresher).
            stale = self._resp_cache.latest(bo.stale_budget_s)
            if stale is not None:
                with self._stats_lock:
                    self.stats.brownout_served += 1
                self._m_brownout_served.inc()
                return stale
        if refresh:
            self.refresh_coalesced()
        now_val = self._resolve_now(now)
        if self._version_source is not None:
            return self._score_response_replica(now_val)
        key = (self.store.version, self.stats.last_refresh_at, now_val)
        body = self._resp_cache.get(key)
        if body is not None:
            with self._stats_lock:
                self.stats.response_cache_hits += 1
            self._m_resp_cache_hits.inc()
            return body
        # last checkpoint before the expensive step: a request whose
        # budget died in refresh/cache-miss handling must not start a
        # device dispatch it cannot use
        _deadline.check("dispatch")

        def compute() -> bytes:
            verdicts = self.score_batch(now=now_val)
            rendered = json.dumps(
                {
                    "backend": verdicts.backend,
                    "stalenessSeconds": verdicts.staleness_seconds,
                    "schedulable": verdicts.schedulable,
                    "scores": verdicts.scores,
                }
            ).encode()
            if verdicts.backend == self.device_backend:
                self._resp_cache.put(
                    (
                        verdicts.store_version,
                        self.stats.last_refresh_at,
                        now_val,
                    ),
                    rendered,
                )
            return rendered

        body, leader = self._score_flight.run(key, compute)
        if not leader:
            with self._stats_lock:
                self.stats.coalesced_scores += 1
            self._m_coalesced.labels(kind="score").inc()
        return body

    def _score_response_replica(self, now_val: float) -> bytes:
        """Replica-mode render: a pure function of (content at the
        applied version fence, ``now``). The key swaps the local
        wall-clock ``last_refresh_at`` for the mirror's applied version;
        the body stamps that version, sorts every key (snapshot-booted
        and delta-fed mirrors ingest rows in different orders), and
        drops wall-clock staleness — so any two replicas at the same
        version key return byte-identical verdicts."""
        applied = self._version_source()
        key = (applied, self.store.version, now_val)
        body = self._resp_cache.get(key)
        if body is not None:
            with self._stats_lock:
                self.stats.response_cache_hits += 1
            self._m_resp_cache_hits.inc()
            return body
        _deadline.check("dispatch")

        def compute() -> bytes:
            verdicts = self.score_batch(now=now_val)
            rendered = json.dumps(
                {
                    "backend": verdicts.backend,
                    "version": applied,
                    "schedulable": verdicts.schedulable,
                    "scores": verdicts.scores,
                },
                sort_keys=True,
                separators=(",", ":"),
            ).encode()
            if verdicts.backend == self.device_backend:
                self._resp_cache.put(key, rendered)
            return rendered

        body, leader = self._score_flight.run(key, compute)
        if not leader:
            with self._stats_lock:
                self.stats.coalesced_scores += 1
            self._m_coalesced.labels(kind="score").inc()
        return body

    # -- assignment --------------------------------------------------------

    def assign_batch(
        self, num_pods: int, capacity: dict | None = None,
        now: float | None = None,
    ) -> "BatchAssignment":
        """Gang-assign ``num_pods`` interchangeable pods across the
        scored nodes (water-filling, same solver as the batch scheduler;
        the north star's "scores/top-k placements out" surface). On the
        CPU a failed solver falls back to the numpy host twin, which
        solves the same placement (both are parity-tested against each
        other); on the card the failure propagates (``fail_open``).
        Rides the shared store snapshot — a concurrent refresh never
        blocks it."""
        from ..scorer.topk import gang_assign_host

        if now is None:
            now = self._clock()
        verdicts = self.score_batch(now=now)
        names = list(verdicts.scores)
        scores = np.asarray(list(verdicts.scores.values()), np.int64)
        schedulable = np.asarray(list(verdicts.schedulable.values()), bool)
        cap = None
        if capacity is not None:
            cap = np.asarray(
                [int(capacity.get(n, 1 << 30)) for n in names], np.int64
            )
        self._m_assign_calls.inc()
        try:
            with self.telemetry.spans.span("assign_batch"):
                result = self._gang(scores, schedulable, num_pods, cap)
            counts = np.asarray(result.counts)
            unassigned = int(result.unassigned)
            waterline = int(result.waterline)
            backend = verdicts.backend
        except Exception:
            if not self.fail_open:
                raise
            self._m_fallbacks.inc()
            with self._stats_lock:
                self.stats.fallbacks += 1
            host = gang_assign_host(
                scores, schedulable, num_pods, self.tensors.hv_count,
                capacity=cap,
            )
            counts = np.asarray(host.counts)
            unassigned = int(host.unassigned)
            waterline = int(host.waterline)
            backend = "host-fallback"
        assignment = BatchAssignment(
            counts={names[i]: int(c) for i, c in enumerate(counts) if c},
            unassigned=unassigned,
            waterline=waterline,
            backend=backend,
            staleness_seconds=verdicts.staleness_seconds,
        )
        # one decision trace per assignment call: the top-k candidates
        # (by score) with their placement counts, the solver backend,
        # and how stale the consulted annotations were
        order = np.argsort(-scores, kind="stable")[:5]
        self.telemetry.decisions.record(
            pod=f"assign[{num_pods}]",
            node=None,
            reason="" if not unassigned else f"{unassigned} unassigned",
            feasible=int(schedulable.sum()),
            top_scores=[(names[int(i)], int(scores[int(i)])) for i in order],
            staleness_seconds=verdicts.staleness_seconds,
            source="assign_batch",
            backend=backend,
            counts_top={
                names[int(i)]: int(counts[int(i)])
                for i in order if counts[int(i)]
            },
        )
        return assignment

    @property
    def _gang(self):
        from ..scorer.topk import GangScheduler

        gang = getattr(self, "_gang_solver", None)
        if gang is None:
            gang = GangScheduler(self.tensors.hv_count, device=self.device)
            self._gang_solver = gang
        return gang

    # -- metrics -----------------------------------------------------------

    def metrics(self) -> dict:
        """Exported counters, legacy JSON shape (the ``/metrics``
        back-compat payload; scrapers get ``render_prometheus``)."""
        with self._stats_lock:
            p50, p99 = self.stats.latencies.percentiles(50, 99)
            return {
                "refreshes": self.stats.refreshes,
                "refresh_skips": self.stats.refresh_skips,
                "score_calls": self.stats.score_calls,
                "coalesced_scores": self.stats.coalesced_scores,
                "response_cache_hits": self.stats.response_cache_hits,
                "fallbacks": self.stats.fallbacks,
                "brownout_served": self.stats.brownout_served,
                "expired_at_dispatch": self.stats.expired_at_dispatch,
                "last_refresh_at": self.stats.last_refresh_at,
                "last_score_seconds": self.stats.last_score_seconds,
                "score_seconds_total": self.stats.score_seconds_total,
                "score_p50_seconds": p50,
                "score_p99_seconds": p99,
                "nodes": len(self.store),
            }

    def render_prometheus(self, openmetrics: bool = False) -> str:
        """The registry in Prometheus text exposition format (or the
        OpenMetrics variant with exemplars when ``openmetrics``)."""
        self._m_nodes.set(len(self.store))
        return self.telemetry.registry.render(openmetrics=openmetrics)
