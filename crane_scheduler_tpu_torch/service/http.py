"""HTTP surfaces: health endpoint + the sidecar scoring API.

Copy of ``crane_scheduler_tpu/service/http.py``, without the threaded
front end's ``protocol`` option (the reference's serving bench uses it
for an HTTP/1.0 leg, which the port has no benchmark for yet).

- ``HealthServer``: ``/healthz`` on the controller health port (default
  8090, ref: cmd/controller/app/server.go:78-84, options.go:54).
- ``ScoringHTTPServer``: the sidecar boundary — ``POST /v1/score``
  evaluates the current store (optionally refreshing first) and returns
  per-node verdicts; ``GET /metrics`` exports the counters the reference
  never had; ``GET /healthz`` for probes.

Two front ends share one transport-agnostic ``ServiceRouter`` (so both
produce byte-identical payloads):

- ``frontend="async"`` (default) — the selectors-based keep-alive
  HTTP/1.1 server (``service.frontend``): one IO thread drains each
  socket's pipelined backlog per wakeup, a small worker pool handles
  requests, and concurrent ``/v1/score`` requests coalesce in the
  service layer (doc/serving.md);
- ``frontend="threaded"`` — the stdlib ``ThreadingHTTPServer``
  comparison/fallback path (keep-alive too: ``protocol_version`` is
  HTTP/1.1 and Content-Length is always sent).

``/metrics`` content-negotiates: a scraper Accept header mentioning
``openmetrics`` gets the OpenMetrics exposition (exemplars + ``# EOF``),
one mentioning ``text/plain`` gets the Prometheus 0.0.4 text exposition,
and anything else gets the legacy JSON counters, so pre-telemetry
clients keep working unchanged. ``GET /debug/decisions`` serves the
sampled decision-trace ring (``?n=`` caps the newest entries),
``GET /debug/lifecycle`` the pod-lifecycle records, and
``GET /debug/trace`` the Chrome trace-event JSON of the recorded spans.

Cross-process tracing: an incoming W3C ``traceparent`` header
is parsed in ``ServiceRouter.handle`` and installed as the thread's
trace context for the request, so the request span — and every service
span recorded underneath (refresh, score_batch, ...) — parents to the
caller's trace. Untraced requests pay one dict lookup.

Stdlib-only.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..telemetry import fleet as fleet_mod
from ..telemetry import tracing
from . import deadline as _deadline
from .deadline import DeadlineExpiredError
from .scoring import LatencyRing, ScoringService

_JSON = "application/json"
_OPENMETRICS = "application/openmetrics-text; version=1.0.0; charset=utf-8"
_ENDPOINTS = (
    "/healthz", "/metrics", "/debug/decisions", "/debug/lifecycle",
    "/debug/trace", "/v1/score", "/v1/assign", "/v1/refresh",
    "/v1/replica/status", "/v1/replication/status",
    "/fleet/metrics", "/v1/slo",
)


class ServiceRouter:
    """Transport-independent request handling shared by both front ends:
    ``(method, target, headers, body) -> (status, content_type, bytes)``.
    ``headers`` keys are lower-cased."""

    def __init__(self, service: ScoringService, health=None,
                 admission=None, brownout=None, replica=None,
                 replication=None, fleet=None):
        self.service = service
        # a ServingReplica (status surface for router health /
        # lag gating) and/or a DeltaPublisher (primary-side feed status)
        self.replica = replica
        self.replication = replication
        # a FleetPlane — /fleet/metrics re-exposes the
        # federated union, /v1/slo the burn-rate/anomaly verdict
        self.fleet = fleet
        # HealthRegistry: /healthz serves its aggregated
        # snapshot — overall worst-of state plus per-component reasons —
        # instead of an unconditional "ok"
        self.health = health
        # overload protection: the admission controller gets
        # the accepted-request latency feed for its gradient limit; the
        # brownout controller rides on the service (serve-stale path)
        self.admission = admission
        self.brownout = brownout
        reg = service.telemetry.registry
        self._m_request_seconds = reg.histogram(
            "crane_service_request_seconds",
            "Service request handling latency (accepted requests only; "
            "sheds land in crane_service_shed_total)",
            labelnames=("endpoint",),
        )
        self._m_inflight = reg.gauge(
            "crane_service_inflight", "Requests currently being handled"
        )
        self._m_shed = reg.counter(
            "crane_service_shed_total",
            "Requests shed before serving, by reason",
            labelnames=("reason",),
        )
        # accepted-request latency window: sheds are excluded so the
        # exported p99 reflects traffic actually served
        self.accepted_latencies = LatencyRing()
        self._lat_lock = threading.Lock()

    def handle(self, method, target, headers, body):
        path, _, _ = target.partition("?")
        endpoint = path if path in _ENDPOINTS else "other"
        ctx = tracing.parse_traceparent(headers.get("traceparent"))
        dl = _deadline.from_headers(headers)
        self._m_inflight.inc()
        start = time.perf_counter()
        shed_reason = None
        try:
            if dl is not None and dl.expired():
                # budget burned on the wire or in the worker queue —
                # shed before any service work
                shed_reason = "deadline_queue"
                return self._shed_response(shed_reason)
            try:
                with _deadline.use(dl):
                    if ctx is None:
                        return self._route(method, target, headers, body)
                    # traced request: the request span parents to the
                    # caller (the pod's root context) and service spans
                    # recorded inside — refresh, score_batch — parent to
                    # the request
                    with self.service.telemetry.spans.span(
                        "service_request", ctx=ctx, endpoint=endpoint,
                        method=method,
                    ):
                        return self._route(method, target, headers, body)
            except DeadlineExpiredError as exc:
                # a checkpoint deeper in the stack (device dispatch)
                # pulled the cord before the expensive step
                shed_reason = f"deadline_{exc.stage}"
                return self._shed_response(shed_reason)
            except Exception:
                return 500, _JSON, json.dumps(
                    {"error": "internal error"}
                ).encode()
        finally:
            self._m_inflight.dec()
            elapsed = time.perf_counter() - start
            if shed_reason is None:
                self._m_request_seconds.labels(endpoint=endpoint).observe(
                    elapsed
                )
                with self._lat_lock:
                    self.accepted_latencies.record(elapsed)
                if self.admission is not None and method == "POST":
                    # the gradient limit keys on served-work latency;
                    # probes/scrapes would only pollute the baseline
                    self.admission.observe(elapsed)
            else:
                self._m_shed.labels(reason=shed_reason).inc()

    @staticmethod
    def _shed_response(reason: str) -> tuple[int, str, bytes]:
        return 504, _JSON, json.dumps(
            {"error": "deadline exceeded", "reason": reason}
        ).encode()

    def handle_inline(self, method, target, headers):
        """The async front end's IO-thread fast path: answer what must
        never wait on a worker slot. ``GET /healthz`` — the whole point
        is a green probe while the pool is saturated or wedged — plus
        the replica/replication status surfaces: the router's
        health/lag gating must keep seeing a replica's lag WHILE that
        replica's workers are saturated, or a storm would read as an
        outage. Returns None for everything else (normal worker path)."""
        path, _, _ = target.partition("?")
        if method == "GET" and path in (
            "/healthz", "/v1/replica/status", "/v1/replication/status",
        ):
            try:
                answered = self._route_get(path, headers)
            except Exception:
                return None
            if answered is not None and answered[0] != 404:
                return answered
        return None

    @staticmethod
    def _json(code: int, payload) -> tuple[int, str, bytes]:
        return code, _JSON, json.dumps(payload).encode()

    @staticmethod
    def _wants_exposition(headers) -> bool:
        """Prometheus/OpenMetrics scrapers name text formats in Accept;
        legacy JSON clients (no Accept, */*, application/json) don't."""
        accept = (headers.get("accept") or "").lower()
        return "text/plain" in accept or "openmetrics" in accept

    @staticmethod
    def _parse_limit(query):
        """Parse ``?n=`` strictly: (ok, limit). Non-integer or negative
        values are a client error (400), never a 500."""
        from urllib.parse import parse_qs

        n = parse_qs(query).get("n", [None])[0]
        if n is None:
            return True, None
        try:
            limit = int(n)
        except ValueError:
            return False, None
        if limit < 0:
            return False, None
        return True, limit

    def _route(self, method, target, headers, body):
        if method == "GET":
            return self._route_get(target, headers)
        if method == "POST":
            return self._route_post(target, body)
        return self._json(404, {"error": "not found"})

    def _route_get(self, target, headers):
        service = self.service
        path, _, query = target.partition("?")
        if path == "/healthz":
            if self.health is not None:
                snap = self.health.snapshot()
                # degraded still probes 200 (the process serves, on the
                # fallback path); only failed flips the probe
                code = 503 if snap["status"] == "failed" else 200
                return self._json(code, snap)
            return self._json(200, {"status": "ok"})
        if path == "/metrics":
            accept = (headers.get("accept") or "").lower()
            if "openmetrics" in accept:
                return (
                    200,
                    _OPENMETRICS,
                    service.render_prometheus(openmetrics=True).encode(),
                )
            if self._wants_exposition(headers):
                return (
                    200,
                    "text/plain; version=0.0.4; charset=utf-8",
                    service.render_prometheus().encode(),
                )
            return self._json(200, service.metrics())
        if path == "/fleet/metrics":
            if self.fleet is None:
                return self._json(404, {"error": "no fleet plane"})
            return (
                200,
                "text/plain; version=0.0.4; charset=utf-8",
                self.fleet.render_metrics().encode(),
            )
        if path == "/v1/slo":
            if self.fleet is None:
                return self._json(404, {"error": "no fleet plane"})
            return self._json(200, self.fleet.slo_status())
        if path == "/debug/decisions":
            ok, limit = self._parse_limit(query)
            if not ok:
                return self._json(
                    400, {"error": "n must be a non-negative integer"}
                )
            buf = service.telemetry.decisions
            return self._json(
                200,
                {"stats": buf.stats(), "decisions": buf.snapshot(limit=limit)},
            )
        if path == "/debug/lifecycle":
            ok, limit = self._parse_limit(query)
            if not ok:
                return self._json(
                    400, {"error": "n must be a non-negative integer"}
                )
            # role in the envelope: lifecycle dumps from N
            # fleet processes must stay distinguishable after the fact
            role = fleet_mod.process_role()
            lc = getattr(service.telemetry, "lifecycle", None)
            if lc is None:
                return self._json(
                    200, {"role": role, "stats": {}, "records": []}
                )
            doc = dict(lc.snapshot(limit=limit))
            doc["role"] = role
            return self._json(200, doc)
        if path == "/debug/trace":
            doc = dict(service.telemetry.export_chrome_trace())
            doc["role"] = fleet_mod.process_role()
            return self._json(200, doc)
        if path == "/v1/replica/status":
            if self.replica is None:
                return self._json(404, {"error": "not a replica"})
            return self._json(200, self.replica.status())
        if path == "/v1/replication/status":
            if self.replication is None:
                return self._json(404, {"error": "no publisher"})
            return self._json(200, self.replication.status())
        return self._json(404, {"error": "not found"})

    def _route_post(self, target, body):
        service = self.service
        path, _, _ = target.partition("?")
        try:
            req = json.loads(body or b"{}")
        except ValueError:
            return self._json(400, {"error": "invalid JSON"})
        if path == "/v1/score":
            now = req.get("now")
            if now is not None and not isinstance(now, (int, float)):
                return self._json(400, {"error": "now must be a number"})
            # pre-rendered, coalesced, version-keyed (doc/serving.md)
            rendered = service.score_response_bytes(
                now=now, refresh=req.get("refresh", True)
            )
            return 200, _JSON, rendered
        if path == "/v1/assign":
            try:
                num_pods = int(req.get("numPods", 0))
                capacity = req.get("capacity")
                if capacity is not None:
                    capacity = {str(k): int(v) for k, v in capacity.items()}
                now = req.get("now")
                if now is not None:
                    now = float(now)
            except (TypeError, ValueError, AttributeError):
                return self._json(400, {
                    "error": "numPods must be an integer, capacity a "
                             "{node: int} map, now a number",
                })
            if req.get("refresh", True):
                service.refresh_coalesced()
            assignment = service.assign_batch(
                num_pods, capacity=capacity, now=now,
            )
            return self._json(200, {
                "backend": assignment.backend,
                "stalenessSeconds": assignment.staleness_seconds,
                "counts": assignment.counts,
                "unassigned": assignment.unassigned,
                "waterline": assignment.waterline,
            })
        if path == "/v1/refresh":
            # forced (not version-gated), but concurrent forces merge
            service._refresh_flight.run(
                ("force", service._cluster_version()), service.refresh
            )
            return self._json(
                200, {"status": "ok", "nodes": len(service.store)}
            )
        return self._json(404, {"error": "not found"})


class _Handler(BaseHTTPRequestHandler):
    # keep-alive on the fallback threaded server too: HTTP/1.1 framing
    # (Content-Length is always sent), not one TCP connection per request
    protocol_version = "HTTP/1.1"
    router: ServiceRouter = None  # set by server factory

    def _dispatch(self, method: str) -> None:
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        headers = {k.lower(): v for k, v in self.headers.items()}
        status, ctype, payload = self.router.handle(
            method, self.path, headers, body
        )
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def log_message(self, *args):
        pass


class ScoringHTTPServer:
    """The sidecar server. ``frontend`` selects the transport: "async"
    (default; selectors-based keep-alive front end) or "threaded" (the
    stdlib fallback). ``CRANE_SERVICE_FRONTEND`` overrides the default."""

    def __init__(
        self,
        service: ScoringService,
        host: str = "127.0.0.1",
        port: int = 0,
        frontend: str | None = None,
        workers: int = 8,
        health=None,
        admission=None,
        brownout=None,
        idle_timeout_s: float | None = 30.0,
        replica=None,
        replication=None,
        fleet=None,
    ):
        if frontend is None:
            frontend = os.environ.get("CRANE_SERVICE_FRONTEND", "async")
        if frontend not in ("async", "threaded"):
            raise ValueError(f"unknown frontend {frontend!r}")
        self.frontend = frontend
        if brownout is not None:
            # the serve-stale brownout path lives in the service
            service.brownout = brownout
        self.router = ServiceRouter(
            service, health=health, admission=admission, brownout=brownout,
            replica=replica, replication=replication, fleet=fleet,
        )
        # primary-side delta feed: GET /v1/replication/feed
        # upgrades to a long-lived stream on the async front end
        stream_handler = (
            replication.stream_handler if replication is not None else None
        )
        self.httpd = None  # the threaded front end's stdlib server
        self._async = None
        self._thread: threading.Thread | None = None
        if frontend == "threaded":
            handler = type("BoundHandler", (_Handler,), {"router": self.router})
            self.httpd = ThreadingHTTPServer((host, port), handler)
        else:
            from .frontend import AsyncHTTPServer

            self._async = AsyncHTTPServer(
                self.router.handle, host=host, port=port, workers=workers,
                inline_handler=self.router.handle_inline,
                admission=admission,
                idle_timeout_s=idle_timeout_s,
                stream_handler=stream_handler,
            )

    @property
    def port(self) -> int:
        if self._async is not None:
            return self._async.port
        return self.httpd.server_port

    @property
    def connections_accepted(self) -> int:
        """Sockets accepted so far (async front end; -1 on threaded)."""
        if self._async is not None:
            return self._async.connections_accepted
        return -1

    def start(self) -> None:
        if self._async is not None:
            self._async.start()
            return
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if self._async is not None:
            self._async.stop()
            return
        self.httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=2.0)


class HealthServer:
    """Bare /healthz, matching the controller's probe surface.

    ``telemetry``: optionally also serve the registry's Prometheus text
    exposition on ``/metrics`` — the scrape surface for controllers
    (annotator, descheduler) that have no scoring sidecar.

    ``health``: a ``HealthRegistry`` — when wired, ``/healthz`` serves
    its aggregated JSON snapshot (503 only when some component is
    ``failed``; ``degraded`` still probes 200 because the process keeps
    serving on its fallback path)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8090,
                 telemetry=None, health=None):
        class Handler(BaseHTTPRequestHandler):
            # keep probe connections alive across requests
            protocol_version = "HTTP/1.1"

            def do_GET(self):
                if self.path == "/healthz":
                    if health is not None:
                        snap = health.snapshot()
                        code = 503 if snap["status"] == "failed" else 200
                        self._reply(
                            code, json.dumps(snap).encode(),
                            "application/json",
                        )
                        return
                    self._reply(200, b"ok", "text/plain")
                elif self.path == "/metrics" and telemetry is not None:
                    self._reply(
                        200,
                        telemetry.registry.render().encode(),
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                else:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()

            def _reply(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self.httpd.server_port

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=2.0)
