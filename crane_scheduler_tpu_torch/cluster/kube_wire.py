"""The kube mirror's wire layer: model decoders, the raw keep-alive
connection, the streaming watch reader and the pooled write worker.

Copy of the wire half of ``crane_scheduler_tpu/cluster/kube.py``
(``node_from_json``, ``pod_from_json``, ``_parse_wall_time``,
``nrt_from_json``, ``event_from_json``, ``WriteResult``,
``_RawHTTPConnection``, ``_WatchStream``, ``_PooledWriter`` with its
status-aware retry). ``cluster/kube.py`` builds ``KubeClusterClient`` on
it. Standard library only, plus the port's model types.

Write semantics (the reference's): merge-patches are idempotent, so a
response-phase transport failure retries them; a POST (binding, eviction,
create) retries only when it provably never reached the wire. 429 retries
for every method, honouring ``Retry-After`` capped at 0.5 s; 5xx retries
only idempotent methods; only 2xx is success.
"""

from __future__ import annotations

import http.client
import json
import queue
import ssl
import threading
import time
import urllib.error
from urllib.parse import urlsplit

from .state import (
    Container,
    Event,
    Node,
    NodeAddress,
    OwnerReference,
    Pod,
    ResourceRequirements,
)

DEFAULT_TIMEOUT_SECONDS = 10.0
WATCH_TIMEOUT_SECONDS = 300.0
SERVICE_ACCOUNT_TOKEN = "/var/run/secrets/kubernetes.io/serviceaccount/token"  # noqa: S105
SERVICE_ACCOUNT_CA = "/var/run/secrets/kubernetes.io/serviceaccount/ca.crt"
NRT_RETRY_SECONDS = 60.0  # re-probe cadence while the CRD is absent

def _deadline_pair() -> tuple[str, str] | None:
    """The ``crane-deadline-ms`` header carrying the calling thread's
    remaining budget, which kube-bound POSTs forward beside traceparent;
    None without an active deadline. The deadline module lives in the
    service package and is imported on first use."""
    from ..service import deadline

    dl = deadline.current()
    if dl is None:
        return None
    return deadline.HEADER, dl.header_value()


def node_from_json(obj: dict) -> Node:
    meta = obj.get("metadata", {})
    status = obj.get("status", {})
    return Node(
        name=meta.get("name", ""),
        annotations=dict(meta.get("annotations") or {}),
        labels=dict(meta.get("labels") or {}),
        addresses=tuple(
            NodeAddress(a.get("type", ""), a.get("address", ""))
            for a in status.get("addresses") or []
        ),
        allocatable=dict(status.get("allocatable") or {}),
    )


def _containers_from_json(items) -> tuple[Container, ...]:
    out = []
    for c in items or []:
        res = c.get("resources") or {}
        out.append(
            Container(
                name=c.get("name", ""),
                resources=ResourceRequirements(
                    requests=dict(res.get("requests") or {}),
                    limits=dict(res.get("limits") or {}),
                ),
            )
        )
    return tuple(out)


def pod_from_json(obj: dict) -> Pod:
    meta = obj.get("metadata", {})
    spec = obj.get("spec", {})
    return Pod(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", "default"),
        annotations=dict(meta.get("annotations") or {}),
        owner_references=tuple(
            OwnerReference(kind=r.get("kind", ""), name=r.get("name", ""))
            for r in meta.get("ownerReferences") or []
        ),
        containers=_containers_from_json(spec.get("containers")),
        node_name=spec.get("nodeName", "") or "",
        init_containers=_containers_from_json(spec.get("initContainers")),
        overhead=dict(spec.get("overhead") or {}),
    )


def _parse_wall_time(value) -> float:
    """RFC3339 (k8s event timestamps) -> epoch seconds; 0.0 on absence."""
    if not value:
        return 0.0
    if isinstance(value, (int, float)):
        return float(value)
    from datetime import datetime

    s = str(value).replace("Z", "+00:00")
    try:
        return datetime.fromisoformat(s).timestamp()
    except ValueError:
        return 0.0


NRT_API_PATH = "/apis/topology.crane.io/v1alpha1/noderesourcetopologies"

# merge-patches are idempotent (last write wins byte-for-byte), so a
# response-phase transport failure can be blindly retried; the binding
# subresource POST is NOT (a duplicate bind 409s on a real apiserver and
# double-emits the Scheduled event on permissive servers), so POSTs only
# retry when the failure happened before a full request reached the wire
_IDEMPOTENT_METHODS = frozenset({"GET", "PUT", "PATCH", "DELETE"})

# status-aware retry policy (the reference's workqueue re-enqueues every
# failed sync with rate-limited backoff, node.go:35-36,68; here the
# write worker itself absorbs the transient-status classes the apiserver
# documents as retryable, so callers only see durable failures):
# 429 = explicitly not processed — safe for every method, POSTs included;
# 5xx = ambiguous (the request MAY have been applied behind a dying
# proxy) — retried only for idempotent merge-patches, never for binds.
_RETRYABLE_ANY = frozenset({429})
_RETRYABLE_IDEMPOTENT = frozenset({500, 502, 503, 504})
# batches at least this large ride the pipelined multi-connection flush:
# the pipelining win needs enough requests per connection to amortize
# the fill/drain machinery over the per-request round-trips it removes
_PIPELINE_FLUSH_MIN = 64
_MAX_STATUS_RETRIES = 3
# retained response-body prefix: enough for an apiserver Status object's
# message, small enough to be free on the hot path. Also caps the
# per-retry sleep below stop()'s 2.0s worker join: worst case
# 3 x 0.5s keeps a throttled worker's FIFO (and the shutdown sentinel
# queued behind it) bounded instead of parking ~6s on Retry-After.
_BODY_SNIPPET_CAP = 512
_MAX_RETRY_SLEEP = 0.5


class WriteResult:
    """Outcome of one pooled write. Truthy on success so boolean callers
    are unchanged; carries the final HTTP status, a snippet of the
    failure body (a 409 bind conflict is now distinguishable from a 422
    validation error or a transport failure), and the retry count."""

    __slots__ = ("ok", "status", "error", "retries")

    def __init__(self, ok: bool, status: int = 0, error: str = "",
                 retries: int = 0):
        self.ok = ok
        self.status = status
        self.error = error
        self.retries = retries

    def __bool__(self) -> bool:
        return self.ok

    def __repr__(self) -> str:
        if self.ok:
            return f"WriteResult(ok, {self.status})"
        return (f"WriteResult(failed, status={self.status}, "
                f"retries={self.retries}, error={self.error!r})")


class _RawResponse:
    """Pre-drained response for _RawHTTPConnection (module-level: the
    hot path must not pay __build_class__ per response)."""

    __slots__ = ("status", "will_close", "retry_after", "_body")

    def __init__(self, status: int, will_close: bool, retry_after, body: bytes):
        self.status = status
        self.will_close = will_close
        self.retry_after = retry_after
        self._body = body

    def read(self) -> bytes:
        return self._body  # already drained; bounded prefix


class _RawHTTPConnection:
    """Hand-rolled HTTP/1.1 keep-alive connection for the pooled write
    path. http.client routes every response's headers through
    email.feedparser (~100us of pure-Python work per response), which
    at annotation-storm rates makes the CLIENT the throughput cap; this
    builds each request in one ``sendall`` and parses responses with a
    minimal reader. Exposes the http.client subset ``_PooledWriter``
    uses (``request``/``getresponse``/``close``).

    With ``context`` the same framing runs over an ``ssl``-wrapped
    socket: after the one-time handshake, a TLS record wrap/unwrap is
    OpenSSL C code — orders cheaper than http.client's per-response
    Python parsing — so the production https path (the reference's
    client-go always talks TLS, options.go:91-136) inherits the same
    fast path as plain http instead of falling back to
    http.client.HTTPSConnection."""

    def __init__(self, host: str, port: int | None, timeout: float,
                 context: ssl.SSLContext | None = None):
        import socket

        self._sock = socket.create_connection(
            (host, port or (443 if context is not None else 80)),
            timeout=timeout,
        )
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if context is not None:
            self._sock = context.wrap_socket(self._sock, server_hostname=host)
        self._rf = self._sock.makefile("rb")
        self._host_hdr = f"{host}:{port}" if port else host

    def send_raw(self, data: bytes) -> None:
        """Write pre-rendered request bytes (pipelined flush path)."""
        self._sock.sendall(data)

    def request(self, method: str, path: str, body=None, headers=None):
        data = body or b""
        lines = [
            f"{method} {path} HTTP/1.1",
            f"Host: {self._host_hdr}",
            f"Content-Length: {len(data)}",
        ]
        for k, v in (headers or {}).items():
            lines.append(f"{k}: {v}")
        self._sock.sendall(
            ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + data
        )

    def getresponse(self):
        try:
            return self._getresponse()
        except (ValueError, IndexError) as exc:
            # malformed status line / header / chunk size: surface as an
            # HTTPException so _do's response-phase retry classification
            # applies (an idempotent PATCH gets its reconnect+retry)
            # instead of escaping to the worker's blanket except
            raise http.client.HTTPException(
                f"malformed response: {exc!r}"
            ) from exc

    def _getresponse(self):
        line = self._rf.readline(65537)
        if not line:
            raise http.client.BadStatusLine("connection closed")
        status = int(line.split(None, 2)[1])
        length = None
        chunked = False
        close = False
        retry_after = None
        while True:
            h = self._rf.readline(65537)
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.partition(b":")
            k, v = k.strip().lower(), v.strip()
            if k == b"content-length":
                length = int(v)
            elif k == b"connection" and v.lower() == b"close":
                close = True
            elif k == b"transfer-encoding" and b"chunked" in v.lower():
                chunked = True
            elif k == b"retry-after":
                retry_after = v.decode("latin-1")
        # drain the body now so the connection is immediately reusable,
        # retaining a bounded prefix so failure statuses stay diagnosable
        kept: list[bytes] = []
        kept_len = 0

        def _keep(piece: bytes):
            nonlocal kept_len
            if kept_len < _BODY_SNIPPET_CAP and piece:
                kept.append(piece[: _BODY_SNIPPET_CAP - kept_len])
                kept_len += len(kept[-1])

        if chunked:
            while True:
                # chunk size may carry extensions ("1a;ext=1"): RFC 7230
                # says ignore them
                size_line = self._rf.readline(65537).partition(b";")[0]
                size = int(size_line.strip() or b"0", 16)
                if size == 0:
                    # trailer section: a server may emit trailer fields
                    # after the terminal chunk — consume lines until the
                    # blank line (or EOF), or the next keep-alive
                    # response on this connection parses as status 0
                    while True:
                        t = self._rf.readline(65537)
                        if t in (b"\r\n", b"\n", b""):
                            break
                    break
                _keep(self._rf.read(size))
                self._rf.readline(65537)  # chunk-trailing CRLF
        elif length is not None:
            _keep(self._rf.read(length))
        else:
            close = True  # read-to-EOF body: not reusable

        return _RawResponse(status, close, retry_after, b"".join(kept))

    def close(self):
        try:
            self._rf.close()
        finally:
            self._sock.close()


class _WatchStream:
    """Raw-socket streaming watch response with an incremental chunked
    de-framer. ``HTTPResponse.read1`` returns at most ONE chunk per call
    — and a watch line is one chunk on the real apiserver and the stub
    alike — so draining a storm through it paid two syscalls plus
    ~10us of http.client bookkeeping per EVENT (measured ~28k events/s
    ceiling). Here one ``recv`` pulls up to 64KB of raw stream and the
    de-framer hands back every payload byte it covers, so the syscall
    and parse cost amortize over the whole buffered backlog."""

    def __init__(self, host: str, port: int | None, path: str,
                 timeout: float, token: str | None = None,
                 context: ssl.SSLContext | None = None):
        import socket as _socket

        self._sock = _socket.create_connection(
            (host, port or (443 if context is not None else 80)),
            timeout=timeout,
        )
        self._sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        if context is not None:
            self._sock = context.wrap_socket(self._sock, server_hostname=host)
        host_hdr = f"{host}:{port}" if port else host
        auth = f"Authorization: Bearer {token}\r\n" if token else ""
        # Connection: close — a watch stream is one-shot (urllib sent
        # the same); without it the server holds the drained socket
        # open for a next request and stream end is never observable
        self._sock.sendall(
            (f"GET {path} HTTP/1.1\r\nHost: {host_hdr}\r\n"
             f"Connection: close\r\n{auth}\r\n").encode("latin-1")
        )
        # response head: status line + headers (read through a small
        # line reader over recv; the body stays in OUR buffer)
        self._raw = bytearray()
        self._eof = False
        status_line = self._head_line()
        try:
            status = int(status_line.split(None, 2)[1])
        except (IndexError, ValueError) as exc:
            self.close()
            raise http.client.HTTPException(
                f"watch: malformed status line {status_line!r}"
            ) from exc
        self._chunked = False
        while True:
            h = self._head_line()
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.partition(b":")
            if k.strip().lower() == b"transfer-encoding" \
                    and b"chunked" in v.strip().lower():
                self._chunked = True
        if status != 200:
            body = bytes(self._raw[:4096])
            self.close()
            raise urllib.error.HTTPError(
                path, status, body.decode("utf-8", "replace"), None, None
            )
        # de-chunker state
        self._chunk_left = 0  # payload bytes pending in current chunk
        self._skip = 0  # chunk-trailing CRLF bytes to discard
        self._in_trailers = False

    def _head_line(self) -> bytes:
        """One CRLF-terminated head line (blocking; head only)."""
        while True:
            idx = self._raw.find(b"\n")
            if idx >= 0:
                line = bytes(self._raw[: idx + 1])
                del self._raw[: idx + 1]
                return line
            d = self._sock.recv(1 << 16)
            if not d:
                return bytes(self._raw)
            self._raw += d

    def fileno(self) -> int:
        return self._sock.fileno()

    def _recv(self) -> bool:
        d = self._sock.recv(1 << 16)
        if not d:
            self._eof = True
            return False
        self._raw += d
        return True

    def _dechunk(self) -> bytes:
        """Consume as much of the raw buffer as the framing allows;
        returns the payload bytes covered (may be empty)."""
        raw = self._raw
        if not self._chunked:
            out = bytes(raw)
            raw.clear()
            return out
        out = bytearray()
        pos = 0
        n = len(raw)
        while pos < n:
            if self._chunk_left:
                take = min(self._chunk_left, n - pos)
                out += raw[pos:pos + take]
                pos += take
                self._chunk_left -= take
                if self._chunk_left:
                    break
                self._skip = 2
            if self._skip:
                take = min(self._skip, n - pos)
                pos += take
                self._skip -= take
                if self._skip:
                    break
            if self._in_trailers:
                # trailer lines until the blank line, then stream end
                ended = False
                while pos < n:
                    idx = raw.find(b"\n", pos)
                    if idx < 0:
                        n = pos  # retain the partial trailer line
                        break
                    line = raw[pos:idx]
                    pos = idx + 1
                    if line in (b"", b"\r"):
                        self._eof = True
                        ended = True
                        break
                if ended or pos >= n:
                    break
                continue
            idx = raw.find(b"\n", pos)
            if idx < 0:
                break  # partial chunk-size line: wait for more bytes
            size_str = bytes(raw[pos:idx]).partition(b";")[0].strip()
            pos = idx + 1
            if not size_str:
                continue
            try:
                size = int(size_str, 16)
            except ValueError:
                # mid-protocol garbage/EOF: end the stream cleanly,
                # like read1's IncompleteRead classification
                self._eof = True
                break
            if size == 0:
                self._in_trailers = True
            else:
                self._chunk_left = size
        del raw[:pos]
        return bytes(out)

    def read_some(self) -> bytes:
        """De-chunked payload after at most the necessary blocking
        ``recv``s (the socket timeout bounds each); b'' = stream end."""
        while True:
            out = self._dechunk()
            if out:
                return out
            if self._eof:
                return b""
            if not self._recv():
                return b""  # abrupt EOF: clean end (torn tail raises)

    def has_buffered(self) -> bool:
        return len(self._raw) > 0

    def shutdown(self) -> None:
        """End the stream from another thread: a reader blocked in
        ``recv`` sees EOF at once (the port's addition, so a client's
        ``stop`` can join its watch threads)."""
        import socket as _socket

        try:
            self._sock.shutdown(_socket.SHUT_RDWR)
        except OSError:
            pass

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class _PooledWriter(threading.Thread):
    """One write worker: a FIFO queue drained over a single persistent
    keep-alive connection.

    The pool routes every write for a given object key to the same
    worker, so writes to one node/pod stay FIFO-ordered process-wide
    while distinct objects patch/bind in parallel — the ordering
    contract the reference gets from client-go's workqueue (at most one
    item per key in flight: node.go:52-70) combined with its pooled
    HTTP/2 transport (``--concurrent-syncs`` workers,
    ref: controller.go:74-77, node.go:29-42). Connection reuse is the
    other half of the win: a fresh urllib request per PATCH pays TCP
    setup and teardown each time.
    """

    def __init__(
        self,
        base_url: str,
        token: str | None,
        context: ssl.SSLContext | None,
        timeout: float,
        retry_counter=None,
    ):
        super().__init__(daemon=True)
        # optional telemetry counter bumped per status-retry sleep
        self._retry_counter = retry_counter
        u = urlsplit(base_url)
        self._scheme = u.scheme
        self._host = u.hostname or "127.0.0.1"
        self._port = u.port
        self._token = token
        self._context = context
        self._timeout = timeout
        self._conn: http.client.HTTPConnection | None = None
        self.queue: queue.SimpleQueue = queue.SimpleQueue()
        # per-worker failure counts by HTTP status (0 = transport);
        # single-writer (this thread), aggregated lock-free by the
        # client's write_failures_by_status property
        self.status_failures: dict[int, int] = {}

    def _connect(self):
        if self._scheme == "https":
            # same raw framing over an ssl-wrapped socket (TCP_NODELAY
            # set before the wrap; every production HTTP client,
            # client-go included, disables Nagle on pooled connections)
            context = self._context
            if context is None:
                context = ssl.create_default_context()
            return _RawHTTPConnection(
                self._host, self._port, self._timeout, context=context
            )
        return _RawHTTPConnection(self._host, self._port, self._timeout)

    def run(self) -> None:
        while True:
            item = self.queue.get()
            if item is None:
                if self._conn is not None:
                    self._conn.close()
                return
            method, path, body, content_type, extra_headers, fut = item
            try:
                result = self._do(method, path, body, content_type,
                                  extra_headers)
            except Exception as exc:  # noqa: BLE001 — a worker must never die
                self._drop_conn()
                self.status_failures[0] = self.status_failures.get(0, 0) + 1
                result = WriteResult(False, 0, f"worker: {exc!r}")
            fut.set_result(result)

    def _drop_conn(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None

    @staticmethod
    def _retry_delay(retry_after, backoff: float) -> float:
        """Honor a numeric Retry-After when present (capped so a
        misbehaving server can't park a worker), else the caller's
        exponential backoff."""
        if retry_after:
            try:
                return min(max(float(retry_after), 0.0), _MAX_RETRY_SLEEP)
            except ValueError:
                pass  # HTTP-date form: fall through to backoff
        return min(backoff, _MAX_RETRY_SLEEP)

    def _do(self, method: str, path: str, body, content_type: str,
            extra_headers: dict | None = None) -> WriteResult:
        if body is None:
            data = None
        elif isinstance(body, bytes):
            data = body  # pre-rendered payload (hot bind/patch paths)
        else:
            data = json.dumps(body).encode()
        headers = {}
        if data is not None:
            headers["Content-Type"] = content_type
        if self._token:
            headers["Authorization"] = f"Bearer {self._token}"
        if extra_headers:
            headers.update(extra_headers)  # e.g. traceparent
        transport_retried = False
        status_retries = 0
        backoff = 0.05
        attempts = 0
        while True:
            attempts += 1
            if self._conn is None:
                self._conn = self._connect()
            try:
                self._conn.request(method, path, body=data, headers=headers)
            except (http.client.HTTPException, OSError) as exc:
                # send-phase failure: the server never saw a complete
                # request (the classic case is a keep-alive connection
                # the server idle-closed between our writes) — always
                # safe to reconnect and retry once, POSTs included
                self._drop_conn()
                if transport_retried:
                    self.status_failures[0] = (
                        self.status_failures.get(0, 0) + 1)
                    return WriteResult(
                        False, 0, f"send: {exc!r}", attempts - 1)
                transport_retried = True
                continue
            try:
                resp = self._conn.getresponse()
                payload = resp.read()  # drained; bounded snippet kept
            except (http.client.HTTPException, OSError) as exc:
                # response-phase failure: the request may have been
                # processed — retry only idempotent methods
                self._drop_conn()
                if transport_retried or method not in _IDEMPOTENT_METHODS:
                    self.status_failures[0] = (
                        self.status_failures.get(0, 0) + 1)
                    return WriteResult(
                        False, 0, f"recv: {exc!r}", attempts - 1)
                transport_retried = True
                continue
            if resp.will_close:
                self._drop_conn()
            # a full request/response cycle completed: the next attempt
            # (status retry) gets a fresh send-phase retry budget — a
            # Retry-After sleep routinely outlives the server's
            # keep-alive idle timeout, and that idle-close send failure
            # is always safe to retry
            transport_retried = False
            status = resp.status
            # only 2xx is success: kube API writes never legitimately
            # succeed via an unfollowed redirect — a 301/302 from an
            # ingress means the apiserver never applied the write
            if 200 <= status < 300:
                return WriteResult(True, status, "", attempts - 1)
            self.status_failures[status] = (
                self.status_failures.get(status, 0) + 1)
            retryable = status in _RETRYABLE_ANY or (
                status in _RETRYABLE_IDEMPOTENT
                and method in _IDEMPOTENT_METHODS
            )
            snippet = payload[:_BODY_SNIPPET_CAP].decode("utf-8", "replace")
            if not retryable or status_retries >= _MAX_STATUS_RETRIES:
                return WriteResult(False, status, snippet, attempts - 1)
            status_retries += 1
            if self._retry_counter is not None:
                self._retry_counter.inc()
            retry_after = getattr(resp, "retry_after", None)
            if retry_after is None and hasattr(resp, "getheader"):
                retry_after = resp.getheader("Retry-After")
            time.sleep(self._retry_delay(retry_after, backoff))
            backoff = min(backoff * 2, 1.0)


def nrt_from_json(obj: dict):
    """gocrane NodeResourceTopology CR -> topology model (ref: the
    gocrane/api CRD shape consumed at
    pkg/plugins/noderesourcetopology/plugin.go:31-71)."""
    from ..topology.types import (
        CraneManagerPolicy,
        NodeResourceTopology,
        Zone,
    )

    meta = obj.get("metadata", {})
    policy = obj.get("craneManagerPolicy", {}) or {}
    return NodeResourceTopology(
        name=meta.get("name", ""),
        crane_manager_policy=CraneManagerPolicy(
            cpu_manager_policy=policy.get("cpuManagerPolicy", ""),
            topology_manager_policy=policy.get("topologyManagerPolicy", ""),
        ),
        zones=tuple(Zone.from_wire(z) for z in obj.get("zones") or []),
    )


def event_from_json(obj: dict) -> Event:
    meta = obj.get("metadata", {})
    return Event(
        namespace=meta.get("namespace", "default"),
        name=meta.get("name", ""),
        type=obj.get("type", ""),
        reason=obj.get("reason", ""),
        message=obj.get("message", ""),
        count=int(obj.get("count") or 0),
        event_time=_parse_wall_time(obj.get("eventTime")),
        last_timestamp=_parse_wall_time(obj.get("lastTimestamp")),
    )
