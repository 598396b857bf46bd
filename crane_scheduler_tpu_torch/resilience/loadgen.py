"""Seeded open-loop load generation and slow-client injection.

Copy of ``crane_scheduler_tpu/resilience/loadgen.py``.

Closed-loop load (each client waits for its response before sending the
next request) self-throttles exactly when the server slows down, so it
can never reproduce congestion collapse. A storm is *open-loop*: the
arrival process does not negotiate. ``StormSchedule`` builds a seeded,
reproducible arrival timeline (Poisson within each rate phase) that two
independent harnesses consume:

- ``replay_admission`` — virtual-time replay: the arrivals run through
  a fresh ``AdmissionController`` state machine under an injected
  ``VirtualClock`` with a fixed service time. No sockets, no sleeps, no
  wall clock — the resulting admit/queue/shed timeline is a pure
  function of (schedule, controller parameters), which is what bench
  config 17's determinism gate compares across same-seed runs.
- ``run_open_loop`` — wire mode: fire the same arrivals as real HTTP
  POSTs against a live frontend, never waiting for one response before
  sending the next. Used by ``chip_smoke.py``'s storm phase and the
  storm tests to prove the IO-thread admission path sheds under real sockets.

``SlowClientSwarm`` is the slowloris injector: N connections that send
a partial request then stall, which is exactly the shape the frontend's
idle reaper must evict (a half-sent request must not pin a connection
slot forever).

Stdlib-only; nothing here imports the service package at module import
time (``replay_admission`` takes a controller factory).
"""

from __future__ import annotations

import heapq
import http.client
import random
import socket
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterable, List, Sequence, Tuple


@dataclass(frozen=True)
class Arrival:
    """One open-loop request: fires at ``t`` seconds from schedule
    start regardless of how earlier requests fared."""

    t: float
    tenant: str = "default"
    low_priority: bool = False
    deadline_ms: float | None = None


class StormSchedule:
    """A seeded open-loop arrival timeline with rate phases.

    ``phases`` is a sequence of ``(start_s, rps)`` pairs — e.g.
    ``[(0, 50), (2, 150), (6, 50)]`` is a 3x storm between t=2s and
    t=6s. Interarrivals inside a phase are exponential (Poisson
    process) from one seeded RNG, so the same seed always yields the
    same timeline, including tenant/priority assignment."""

    def __init__(
        self,
        seed: int,
        *,
        duration_s: float,
        phases: Sequence[Tuple[float, float]],
        tenants: Sequence[str] = ("default",),
        low_priority_frac: float = 0.0,
        deadline_ms: float | None = None,
    ):
        if not phases:
            raise ValueError("need at least one (start_s, rps) phase")
        self.seed = int(seed)
        self.duration_s = float(duration_s)
        self.phases = sorted((float(s), float(r)) for s, r in phases)
        self.tenants = tuple(tenants) or ("default",)
        self.low_priority_frac = float(low_priority_frac)
        self.deadline_ms = deadline_ms
        self.arrivals: List[Arrival] = self._build()

    @staticmethod
    def storm(
        seed: int,
        *,
        baseline_rps: float,
        storm_x: float = 3.0,
        warm_s: float = 1.0,
        storm_s: float = 3.0,
        cool_s: float = 1.0,
        **kw,
    ) -> "StormSchedule":
        """The canonical shape: warm at baseline, storm at
        ``storm_x * baseline``, cool back down."""
        return StormSchedule(
            seed,
            duration_s=warm_s + storm_s + cool_s,
            phases=[
                (0.0, baseline_rps),
                (warm_s, baseline_rps * storm_x),
                (warm_s + storm_s, baseline_rps),
            ],
            **kw,
        )

    def _rate_at(self, t: float) -> float:
        rate = self.phases[0][1]
        for start, rps in self.phases:
            if t >= start:
                rate = rps
            else:
                break
        return rate

    def _build(self) -> List[Arrival]:
        rng = random.Random(self.seed)
        arrivals: List[Arrival] = []
        t = 0.0
        while t < self.duration_s:
            rate = self._rate_at(t)
            if rate <= 0:
                # dead phase: jump to the next phase boundary
                nxt = [s for s, _ in self.phases if s > t]
                if not nxt:
                    break
                t = nxt[0]
                continue
            t += rng.expovariate(rate)
            if t >= self.duration_s:
                break
            tenant = self.tenants[rng.randrange(len(self.tenants))]
            low = rng.random() < self.low_priority_frac
            arrivals.append(
                Arrival(t, tenant, low, self.deadline_ms)
            )
        return arrivals

    def __len__(self) -> int:
        return len(self.arrivals)

    def __iter__(self):
        return iter(self.arrivals)


# -- virtual-time replay ----------------------------------------------------


class VirtualClock:
    """An injectable monotonic clock the replay advances by hand."""

    __slots__ = ("now",)

    def __init__(self, now: float = 0.0):
        self.now = float(now)

    def __call__(self) -> float:
        return self.now


def arrival_headers(a: Arrival) -> dict:
    """The wire headers an ``Arrival`` carries (lower-cased keys, the
    frontend's parse convention)."""
    headers = {"crane-tenant": a.tenant}
    if a.low_priority:
        headers["crane-priority"] = "low"
    if a.deadline_ms is not None:
        headers["crane-deadline-ms"] = f"{a.deadline_ms:.3f}"
    return headers


def replay_admission(
    arrivals: Iterable[Arrival],
    admission_factory: Callable[[Callable[[], float]], object],
    *,
    service_time_s: float = 0.01,
    target: str = "/score/batch",
) -> List[Tuple[float, str, str]]:
    """Run an arrival schedule through an admission state machine in
    virtual time. Returns the decision timeline: ``(t, event, tenant)``
    tuples where event is ``admit`` / ``queue`` / ``dequeue`` /
    ``shed:<reason>``, in event order.

    ``admission_factory(clock)`` must return a fresh AdmissionController
    (or compatible) built on the provided clock — fresh state per call
    is what makes same-seed replays bit-identical."""
    clock = VirtualClock()
    adm = admission_factory(clock)
    timeline: List[Tuple[float, str, str]] = []
    done_heap: List[Tuple[float, int, Arrival]] = []  # (t, seq, arrival)
    seq = 0
    it = iter(sorted(arrivals, key=lambda a: a.t))
    nxt = next(it, None)
    while nxt is not None or done_heap:
        take_done = done_heap and (
            nxt is None or done_heap[0][0] <= nxt.t
        )
        if take_done:
            t, _, fin = heapq.heappop(done_heap)
            clock.now = t
            adm.observe(service_time_s)
            handed = adm.finish()
            if handed is not None:
                timeline.append((t, "dequeue", handed.tenant))
                seq += 1
                heapq.heappush(done_heap, (t + service_time_s, seq, handed))
            continue
        a, nxt = nxt, next(it, None)
        clock.now = a.t
        decision = adm.classify("POST", target, arrival_headers(a), now=a.t)
        if decision is not None:
            adm.count_shed(decision.reason)
            timeline.append((a.t, f"shed:{decision.reason}", a.tenant))
        elif adm.acquire():
            timeline.append((a.t, "admit", a.tenant))
            seq += 1
            heapq.heappush(done_heap, (a.t + service_time_s, seq, a))
        elif adm.queue(a.tenant, a):
            timeline.append((a.t, "queue", a.tenant))
        else:
            adm.count_shed("queue_full")
            timeline.append((a.t, "shed:queue_full", a.tenant))
    return timeline


def timeline_counts(timeline: Sequence[Tuple[float, str, str]]) -> dict:
    """Event counts (``admit``/``queue``/``dequeue``/``shed:*`` keys)."""
    counts: dict = {}
    for _, event, _ in timeline:
        counts[event] = counts.get(event, 0) + 1
    return counts


# -- wire mode --------------------------------------------------------------


@dataclass
class WireResult:
    """One open-loop request's outcome on the wire."""

    t: float
    status: int  # 0 = transport error
    latency_s: float
    error: str | None = None


def run_open_loop(
    host: str,
    port: int,
    arrivals: Iterable[Arrival],
    *,
    target: str = "/score/batch",
    body: bytes = b"{}",
    body_fn: "Callable[[int, Arrival], bytes] | None" = None,
    time_scale: float = 1.0,
    timeout_s: float = 10.0,
) -> List[WireResult]:
    """Fire the schedule as real HTTP POSTs, one thread per in-flight
    request, never waiting for a response before the next send — the
    open-loop property. ``time_scale`` compresses the schedule (0.1 =
    10x faster than nominal). ``body_fn(index, arrival)`` builds a
    per-request body (e.g. a unique ``now`` to defeat the response
    cache so every accepted request costs a real render); when None,
    ``body`` is sent verbatim. Returns results in arrival order."""
    ordered = sorted(arrivals, key=lambda a: a.t)
    results: List[WireResult | None] = [None] * len(ordered)
    threads: List[threading.Thread] = []
    start = time.monotonic()

    def fire(i: int, a: Arrival) -> None:
        sent = time.monotonic()
        try:
            conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
            try:
                headers = dict(arrival_headers(a))
                headers["Content-Type"] = "application/json"
                payload = body_fn(i, a) if body_fn is not None else body
                conn.request("POST", target, body=payload, headers=headers)
                resp = conn.getresponse()
                resp.read()
                results[i] = WireResult(
                    a.t, resp.status, time.monotonic() - sent
                )
            finally:
                conn.close()
        except Exception as exc:  # noqa: BLE001 — outcome, not failure
            results[i] = WireResult(
                a.t, 0, time.monotonic() - sent, error=repr(exc)
            )

    for i, a in enumerate(ordered):
        delay = start + a.t * time_scale - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        th = threading.Thread(target=fire, args=(i, a), daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout_s)
    return [
        r if r is not None else WireResult(ordered[i].t, 0, 0.0, "no result")
        for i, r in enumerate(results)
    ]


# -- slowloris --------------------------------------------------------------


class SlowClientSwarm:
    """N connections that send a partial request then stall — the
    attack shape the frontend's idle reaper must break. The preamble
    advertises a Content-Length that never arrives, so the server's
    parser (correctly) keeps waiting; only the idle timeout can free
    the slot."""

    PREAMBLE = (
        b"POST /score/batch HTTP/1.1\r\n"
        b"Host: storm\r\n"
        b"Content-Type: application/json\r\n"
        b"Content-Length: 1048576\r\n"
        b"\r\n"
        b'{"partial'
    )

    def __init__(self, host: str, port: int, count: int = 4,
                 connect_timeout_s: float = 5.0):
        self.socks: List[socket.socket] = []
        for _ in range(max(1, int(count))):
            s = socket.create_connection((host, port), connect_timeout_s)
            s.sendall(self.PREAMBLE)
            s.setblocking(False)
            self.socks.append(s)

    def poll_closed(self) -> int:
        """How many of the stalled connections the server has closed
        (recv returning b'' / a reset). Non-blocking."""
        closed = 0
        for s in self.socks:
            try:
                data = s.recv(4096)
                if data == b"":
                    closed += 1
                # a response (408/timeout close) followed by FIN also
                # counts once the FIN lands on a later poll
            except BlockingIOError:
                pass
            except OSError:
                closed += 1
        return closed

    def wait_closed(self, count: int, timeout_s: float = 10.0,
                    poll_s: float = 0.05) -> int:
        """Poll until >= ``count`` connections are server-closed or the
        timeout lapses; returns the final closed count."""
        deadline = time.monotonic() + timeout_s
        closed = self.poll_closed()
        while closed < count and time.monotonic() < deadline:
            time.sleep(poll_s)
            closed = self.poll_closed()
        return closed

    def close(self) -> None:
        for s in self.socks:
            try:
                s.close()
            except OSError:
                pass
        self.socks = []

    def __enter__(self) -> "SlowClientSwarm":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
