"""Consistent-hash replica router.

Copy of ``crane_scheduler_tpu/service/router.py``.

The thin front end over N shared-nothing serving replicas. It reuses
the async IO-thread parser (``service.frontend``) for its own listener,
keeps NO scoring state, and does exactly four things per request:

- **pick** a replica — consistent hash over the tenant key (crc32 +
  virtual nodes, the ``cluster.shards`` hashing idiom) so a tenant's
  requests keep landing on the same replica's warm cache; ``mode=
  "rr"`` degrades to round-robin for tenant-less traffic;
- **gate** — a replica is routable only while its latest health probe
  succeeded AND its mirror's applied version is within ``lag_budget_
  versions`` of the primary's published version (catch-up gating: a
  replica that is behind serves stale verdicts; better to shed load
  toward caught-up peers than to serve them);
- **forward** with the REMAINING deadline budget re-minted into
  ``crane-deadline-ms`` (budget burned in the router
  is charged against the request, relative budgets survive clock skew)
  and the tenant/trace headers passed through;
- **eject** — a connect/transport failure marks the replica unroutable
  on the spot and the request retries on the next ring replica
  (score/assign are idempotent reads); the background prober restores
  the replica when it answers again.

Metrics: ``crane_router_requests_total{replica}``,
``crane_router_retries_total``, ``crane_router_ejections_total
{replica}``, ``crane_router_routable``, ``crane_router_no_replica_
total``, ``crane_router_replica_lag_versions{replica}``. Stdlib-only.
"""

from __future__ import annotations

import json
import threading
import time
import zlib
from bisect import bisect_right
from http.client import HTTPConnection

from ..telemetry import Telemetry
from . import deadline as _deadline
from .frontend import AsyncHTTPServer
from .overload import TENANT_HEADER

_JSON = "application/json"
_VNODES = 64
_HOP_STRIP = frozenset((
    "host", "connection", "content-length", _deadline.HEADER,
    _deadline._ANCHOR_KEY,
))


def _hash(key: str) -> int:
    return zlib.crc32(key.encode("utf-8"))


class _Backend:
    """One replica target plus its gating state (written by the prober
    and the request path, read by the ring walk)."""

    __slots__ = (
        "name", "host", "port", "routable", "healthy", "applied_version",
        "lag_versions", "failures", "_local",
    )

    def __init__(self, name: str, host: str, port: int):
        self.name = name
        self.host = host
        self.port = int(port)
        self.routable = False
        self.healthy = False
        self.applied_version = -1
        self.lag_versions = 0
        self.failures = 0
        self._local = threading.local()  # per-worker keep-alive conn

    def connection(self, timeout_s: float) -> HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = HTTPConnection(self.host, self.port, timeout=timeout_s)
            self._local.conn = conn
        return conn

    def drop_connection(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass
            self._local.conn = None


class ReplicaRouter:
    """``replicas`` is ``[(name, host, port), ...]``. ``primary`` is the
    publisher's ``(host, port)`` — its ``/v1/replication/status`` is the
    published-version authority for lag gating (omit it and lag is
    computed against the highest applied version any replica reports)."""

    def __init__(
        self,
        replicas,
        *,
        primary: tuple[str, int] | None = None,
        mode: str = "hash",
        lag_budget_versions: int = 8,
        host: str = "127.0.0.1",
        port: int = 0,
        workers: int = 8,
        probe_interval_s: float = 0.25,
        probe_timeout_s: float = 2.0,
        forward_timeout_s: float = 30.0,
        telemetry: Telemetry | None = None,
    ):
        if mode not in ("hash", "rr"):
            raise ValueError(f"unknown router mode {mode!r}")
        self.mode = mode
        self.lag_budget_versions = int(lag_budget_versions)
        self.primary = primary
        self.probe_interval_s = float(probe_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.forward_timeout_s = float(forward_timeout_s)
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self._backends = [
            _Backend(name, bhost, bport) for name, bhost, bport in replicas
        ]
        if not self._backends:
            raise ValueError("router needs at least one replica")
        # the ring is static (replica set is fixed per router); gating
        # happens at walk time, so ejection costs zero ring rebuilds
        points = []
        for b in self._backends:
            for i in range(_VNODES):
                points.append((_hash(f"{b.name}#{i}"), b))
        points.sort(key=lambda p: p[0])
        self._ring_keys = [p[0] for p in points]
        self._ring = [p[1] for p in points]
        self._rr = 0
        self._rr_lock = threading.Lock()
        self._published_version = -1
        self.stats = {"requests": 0, "retries": 0, "no_replica": 0,
                      "ejections": 0}
        reg = self.telemetry.registry
        self._m_requests = reg.counter(
            "crane_router_requests_total",
            "Requests forwarded, by serving replica",
            labelnames=("replica",),
        )
        self._m_retries = reg.counter(
            "crane_router_retries_total",
            "Forwards retried on another replica after a transport failure",
        )
        self._m_ejections = reg.counter(
            "crane_router_ejections_total",
            "Replica ejections (transport failure or failed probe)",
            labelnames=("replica",),
        )
        self._m_routable = reg.gauge(
            "crane_router_routable", "Replicas currently routable"
        )
        self._m_no_replica = reg.counter(
            "crane_router_no_replica_total",
            "Requests shed because no replica was routable",
        )
        self._m_lag = reg.gauge(
            "crane_router_replica_lag_versions",
            "Published version minus the replica's applied version",
            labelnames=("replica",),
        )
        self._server = AsyncHTTPServer(
            self._handle, host=host, port=port, workers=workers,
            inline_handler=self._handle_inline,
        )
        self._stop = threading.Event()
        self._prober: threading.Thread | None = None

    # -- lifecycle ----------------------------------------------------------

    @property
    def port(self) -> int:
        return self._server.port

    def start(self) -> None:
        self.probe_once()
        self._prober = threading.Thread(
            target=self._probe_loop, name="crane-router-probe", daemon=True
        )
        self._prober.start()
        self._server.start()

    def stop(self) -> None:
        self._stop.set()
        if self._prober is not None:
            self._prober.join(timeout=5.0)
        self._server.stop()
        for b in self._backends:
            b.drop_connection()

    # -- health / lag gating ------------------------------------------------

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_interval_s):
            try:
                self.probe_once()
            except Exception:  # pragma: no cover - prober must survive
                pass

    def _get_json(self, host: str, port: int, path: str):
        conn = HTTPConnection(host, port, timeout=self.probe_timeout_s)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                return None
            return json.loads(body)
        finally:
            conn.close()

    def probe_once(self) -> None:
        """One gating pass: refresh the published-version authority,
        probe every replica's status surface, recompute routability."""
        published = -1
        if self.primary is not None:
            try:
                status = self._get_json(
                    self.primary[0], self.primary[1],
                    "/v1/replication/status",
                )
                if status is not None:
                    published = int(status.get("publishedVersion", -1))
            except Exception:
                published = -1
        for b in self._backends:
            try:
                status = self._get_json(
                    b.host, b.port, "/v1/replica/status"
                )
            except Exception:
                status = None
            if status is None:
                if b.healthy:
                    self._eject(b, "probe")
                b.healthy = False
                b.routable = False
                continue
            b.healthy = True
            b.applied_version = int(status.get("appliedVersion", -1))
            published = max(
                published, int(status.get("publishedHint", -1))
            )
        if published < 0:
            published = max(
                (b.applied_version for b in self._backends), default=-1
            )
        self._published_version = published
        for b in self._backends:
            if not b.healthy:
                continue
            b.lag_versions = max(0, published - b.applied_version)
            self._m_lag.labels(replica=b.name).set(b.lag_versions)
            was = b.routable
            b.routable = b.lag_versions <= self.lag_budget_versions
            if was and not b.routable:
                self._eject(b, "lag")
        self._m_routable.set(sum(1 for b in self._backends if b.routable))

    def _eject(self, backend: _Backend, reason: str) -> None:
        backend.routable = False
        backend.failures += 1
        self.stats["ejections"] += 1
        self._m_ejections.labels(replica=backend.name).inc()
        self._m_routable.set(sum(1 for b in self._backends if b.routable))

    # -- replica selection --------------------------------------------------

    def _routable(self) -> list[_Backend]:
        return [b for b in self._backends if b.routable]

    def route_for(self, tenant: str) -> str | None:
        """The replica name a tenant's requests land on right now (the
        head of the forward order). Ops/bench surface: answers 'where
        does tenant X go' without sending a request."""
        picked = self._pick({TENANT_HEADER: tenant})
        return picked[0].name if picked else None

    def _pick(self, headers) -> list[_Backend]:
        """The forward order: primary pick first, then every other
        routable replica as transport-failure fallbacks."""
        live = self._routable()
        if not live:
            return []
        tenant = (headers.get(TENANT_HEADER) or "").strip()
        if self.mode == "hash" and tenant:
            # walk the static ring from the tenant's point, keeping the
            # first routable owner; fallbacks follow in ring order
            start = bisect_right(self._ring_keys, _hash(tenant))
            n = len(self._ring)
            ordered: list[_Backend] = []
            for i in range(n):
                b = self._ring[(start + i) % n]
                if b.routable and b not in ordered:
                    ordered.append(b)
            return ordered
        with self._rr_lock:
            self._rr = (self._rr + 1) % len(live)
            start = self._rr
        return live[start:] + live[:start]

    # -- request path -------------------------------------------------------

    def _handle_inline(self, method, target, headers):
        path, _, _ = target.partition("?")
        if method != "GET":
            return None
        if path == "/healthz":
            live = len(self._routable())
            code = 200 if live else 503
            return code, _JSON, json.dumps(
                {"status": "ok" if live else "no_replica",
                 "routable": live,
                 "replicas": len(self._backends)}
            ).encode()
        if path == "/v1/router/status":
            return 200, _JSON, json.dumps(self.status()).encode()
        return None

    def _handle(self, method, target, headers, body):
        inline = self._handle_inline(method, target, headers)
        if inline is not None:
            return inline
        path, _, _ = target.partition("?")
        if method == "GET" and path == "/metrics":
            return (
                200,
                "text/plain; version=0.0.4; charset=utf-8",
                self.telemetry.registry.render().encode(),
            )
        dl = _deadline.from_headers(headers)
        if dl is not None and dl.expired():
            return 504, _JSON, json.dumps(
                {"error": "deadline exceeded", "reason": "deadline_router"}
            ).encode()
        candidates = self._pick(headers)
        if not candidates:
            self.stats["no_replica"] += 1
            self._m_no_replica.inc()
            return 503, _JSON, json.dumps(
                {"error": "overloaded", "reason": "no_replica"}
            ).encode()
        fwd_headers = {
            k: v for k, v in headers.items() if k not in _HOP_STRIP
        }
        last_error = "unreachable"
        for attempt, backend in enumerate(candidates):
            if dl is not None:
                if dl.expired():
                    return 504, _JSON, json.dumps(
                        {"error": "deadline exceeded",
                         "reason": "deadline_router"}
                    ).encode()
                # forward the REMAINING budget, not the original
                fwd_headers[_deadline.HEADER] = dl.header_value()
            if attempt:
                self.stats["retries"] += 1
                self._m_retries.inc()
            try:
                status, ctype, payload = self._forward(
                    backend, method, target, fwd_headers, body
                )
            except Exception as exc:
                last_error = f"{type(exc).__name__}"
                backend.drop_connection()
                self._eject(backend, "transport")
                continue
            self.stats["requests"] += 1
            self._m_requests.labels(replica=backend.name).inc()
            return status, ctype, payload
        return 503, _JSON, json.dumps(
            {"error": "overloaded", "reason": "no_replica",
             "detail": last_error}
        ).encode()

    def _forward(self, backend: _Backend, method, target, headers, body):
        conn = backend.connection(self.forward_timeout_s)
        try:
            conn.request(method, target, body=body or None, headers=headers)
            resp = conn.getresponse()
            payload = resp.read()
        except Exception:
            # one clean retry on a fresh connection: the pooled
            # keep-alive socket may simply have idled out server-side
            backend.drop_connection()
            conn = backend.connection(self.forward_timeout_s)
            conn.request(method, target, body=body or None, headers=headers)
            resp = conn.getresponse()
            payload = resp.read()
        ctype = resp.getheader("Content-Type") or _JSON
        return resp.status, ctype, payload

    def status(self) -> dict:
        return {
            "mode": self.mode,
            "publishedVersion": self._published_version,
            "lagBudgetVersions": self.lag_budget_versions,
            "replicas": [
                {
                    "name": b.name,
                    "port": b.port,
                    "healthy": b.healthy,
                    "routable": b.routable,
                    "appliedVersion": b.applied_version,
                    "lagVersions": b.lag_versions,
                    "failures": b.failures,
                }
                for b in self._backends
            ],
            "stats": dict(self.stats),
        }
