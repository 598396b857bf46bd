"""Selectors-based keep-alive HTTP/1.1 front end for the scoring service.

Copy of ``crane_scheduler_tpu/service/frontend.py``.

One non-blocking IO thread owns every socket. It accepts, drains each
readable socket's buffered backlog per wakeup, and frames requests out
of a per-connection byte buffer exactly like the kube watch-stream
parser: bytes accumulate however the kernel tore them, and complete
requests (request line + headers + Content-Length body) are carved off
incrementally. Handling runs on a small worker pool — each connection
has at most ONE handler job in flight, which consumes that connection's
parsed backlog FIFO and hands one rendered byte-string back to the IO
thread. So:

- responses to pipelined requests stay in request order by construction;
- a pipelined burst costs one job dispatch and one ``send``, not one
  thread per request;
- connections are keep-alive by default (HTTP/1.1 semantics; a
  ``Connection: close`` request or an HTTP/1.0 request without
  ``keep-alive`` closes after the response).

The stdlib ``ThreadingHTTPServer`` front end (``frontend="threaded"``
on ``ScoringHTTPServer``) stays as the comparison/fallback path.

Overload protection lives on the IO thread, where a
decision costs a dict lookup instead of a worker slot:

- an ``inline_handler`` (the router's ``handle_inline``) answers
  ``GET /healthz`` without a worker-pool hop, so probes stay green
  when every worker is saturated or wedged;
- an ``AdmissionController`` classifies each parsed request (expired
  deadline → 504, over-rate tenant → 429 + Retry-After, background
  priority under brownout tier 2 → 503) and gates job dispatch on an
  adaptive concurrency limit, parking ready connections in bounded
  per-tenant queues with weighted-fair handoff;
- an idle/read-timeout reaper closes stalled connections (slowloris:
  a half-sent request cannot pin a connection slot indefinitely).

Every IO-thread response rides ``_enqueue_write`` — the same FIFO the
workers use — so pipelined response ordering holds by construction no
matter who answered.
"""

from __future__ import annotations

import json
import selectors
import socket
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

_MAX_HEADER_BYTES = 64 * 1024
_MAX_BODY_BYTES = 64 << 20
_RECV_CHUNK = 1 << 18

_REASONS = {
    200: "OK",
    400: "Bad Request",
    404: "Not Found",
    413: "Payload Too Large",
    429: "Too Many Requests",
    431: "Request Header Fields Too Large",
    500: "Internal Server Error",
    501: "Not Implemented",
    503: "Service Unavailable",
    504: "Gateway Timeout",
}


def render_response(
    status: int, content_type: str, body: bytes, close: bool = False,
    extra_headers: dict | None = None,
) -> bytes:
    head = (
        f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}\r\n"
        f"Content-Type: {content_type}\r\n"
        f"Content-Length: {len(body)}\r\n"
    )
    if extra_headers:
        for name, value in extra_headers.items():
            head += f"{name}: {value}\r\n"
    if close:
        head += "Connection: close\r\n"
    return (head + "\r\n").encode("latin-1") + body


def render_shed(status: int, reason: str, retry_after_s: float = 0.0,
                close: bool = False) -> bytes:
    """A pre-rendered shed response (429/503/504 + Retry-After)."""
    body = json.dumps({"error": "overloaded" if status != 504
                       else "deadline exceeded", "reason": reason}).encode()
    extra = (
        {"Retry-After": f"{retry_after_s:.3f}"} if retry_after_s > 0 else None
    )
    return render_response(
        status, "application/json", body, close=close, extra_headers=extra
    )


class _Conn:
    __slots__ = (
        "sock", "fd", "inbuf", "outbuf", "scan_from", "head_end",
        "body_len", "req_head", "pending", "job_active", "close_after",
        "read_eof", "lock", "registered", "dead", "writes_queued",
        "last_activity", "queued", "stream",
    )

    def __init__(self, sock):
        self.sock = sock
        self.fd = sock.fileno()
        self.inbuf = bytearray()
        self.outbuf = bytearray()
        self.scan_from = 0  # resume point for the \r\n\r\n search
        self.head_end = None  # byte offset past the parsed header block
        self.body_len = 0
        self.req_head = None  # (method, target, headers, keep_alive)
        self.pending: list = []  # parsed requests awaiting the worker
        self.job_active = False
        self.close_after = False  # close once outbuf drains and job ends
        self.read_eof = False
        self.lock = threading.Lock()
        self.registered = 0  # current selector interest mask
        self.dead = False
        self.writes_queued = 0  # responses enqueued but not yet drained
        self.last_activity = time.monotonic()  # idle-reaper anchor
        self.queued = False  # parked in an admission tenant queue
        self.stream = False  # upgraded to a long-lived delta stream


class StreamHandle:
    """A publisher's grip on one claimed stream connection. ``send``
    rides the server's ordinary write FIFO (any thread may call it) and
    reports liveness: False once the connection has died, which is the
    publisher's cue to drop the consumer."""

    __slots__ = ("_server", "_conn")

    def __init__(self, server: "AsyncHTTPServer", conn: _Conn):
        self._server = server
        self._conn = conn

    @property
    def fd(self) -> int:
        return self._conn.fd

    @property
    def alive(self) -> bool:
        return not self._conn.dead

    def send(self, data: bytes) -> bool:
        conn = self._conn
        if conn.dead:
            return False
        if data:
            self._server._enqueue_write(conn, data, False)
        return True

    def close(self) -> None:
        self._server._enqueue_write(self._conn, b"", True)


class AsyncHTTPServer:
    """The non-blocking front end. ``handler`` is the transport-agnostic
    router: ``(method, target, headers, body) -> (status, content_type,
    body_bytes)``; it runs on the worker pool and may block (device
    dispatch, single-flight waits)."""

    def __init__(self, handler, host: str = "127.0.0.1", port: int = 0,
                 workers: int = 8, inline_handler=None, admission=None,
                 idle_timeout_s: float | None = 30.0, stream_handler=None):
        self._handler = handler
        # fast non-blocking answers on the IO thread (GET /healthz):
        # (method, target, headers) -> (status, ctype, body) | None
        self._inline = inline_handler
        # long-lived stream claim (replication feed): (method, target,
        # headers) -> (status, ctype, attach) | None. A claimed
        # connection gets a headers-only response (no Content-Length —
        # read-until-close semantics), leaves the request parser for
        # good, and its writes ride the ordinary write FIFO via a
        # StreamHandle passed to ``attach``.
        self._stream = stream_handler
        # overload.AdmissionController (or None = admit everything)
        self._admission = admission
        self._idle_timeout = (
            float(idle_timeout_s) if idle_timeout_s else None
        )
        self._last_sweep = time.monotonic()
        self._listener = socket.create_server((host, port), backlog=512)
        self._listener.setblocking(False)
        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="crane-http"
        )
        self._conns: dict[int, _Conn] = {}
        self._writes: deque = deque()  # (conn, bytes, close) from workers
        self._writes_lock = threading.Lock()
        self._stopping = threading.Event()
        self._thread: threading.Thread | None = None
        self.connections_accepted = 0
        self.idle_closed = 0  # reaper victims (slowloris defense)
        self.inline_served = 0  # IO-thread answers (no worker hop)
        self.streams_opened = 0  # connections upgraded to delta streams

    @property
    def port(self) -> int:
        return self._listener.getsockname()[1]

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stopping.set()
        self._wakeup()
        if self._thread:
            self._thread.join(timeout=5.0)
        self._pool.shutdown(wait=False)
        try:
            self._wake_w.close()
        except OSError:
            pass

    def _wakeup(self) -> None:
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    # -- IO thread ---------------------------------------------------------

    def _run(self) -> None:
        sel = self._sel
        sel.register(self._listener, selectors.EVENT_READ, "accept")
        sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        tick = 1.0
        if self._idle_timeout is not None:
            tick = min(1.0, max(0.02, self._idle_timeout / 4.0))
        try:
            while not self._stopping.is_set():
                for key, events in sel.select(timeout=tick):
                    if key.data == "accept":
                        self._accept()
                    elif key.data == "wake":
                        self._drain_wake()
                        self._drain_writes()
                    else:
                        conn = key.data
                        if events & selectors.EVENT_READ and not conn.dead:
                            self._on_readable(conn)
                        if events & selectors.EVENT_WRITE and not conn.dead:
                            self._flush(conn)
                if self._idle_timeout is not None:
                    now = time.monotonic()
                    if now - self._last_sweep >= tick:
                        self._last_sweep = now
                        self._sweep_idle(now)
        finally:
            for conn in list(self._conns.values()):
                self._close_conn(conn)
            for sock in (self._listener, self._wake_r):
                try:
                    sel.unregister(sock)
                except (KeyError, ValueError):
                    pass
                try:
                    sock.close()
                except OSError:
                    pass
            sel.close()

    def _drain_wake(self) -> None:
        try:
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, OSError):
            pass

    def _accept(self) -> None:
        while True:
            try:
                sock, _ = self._listener.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = _Conn(sock)
            self._conns[conn.fd] = conn
            self.connections_accepted += 1
            self._sel.register(sock, selectors.EVENT_READ, conn)
            conn.registered = selectors.EVENT_READ

    def _sweep_idle(self, now: float) -> None:
        """Close connections with no forward progress for the idle
        window — the slowloris defense. A connection with an active
        job, parsed-but-unserved requests, or a parked admission slot
        is the server's debt, not the client's, and is exempt. So is a
        stream connection: a replication feed legitimately goes quiet
        between version windows, and reaping it would force every
        replica through a resume cycle each idle window."""
        timeout = self._idle_timeout
        for conn in list(self._conns.values()):
            if conn.dead or conn.stream:
                continue
            if now - conn.last_activity <= timeout:
                continue
            with conn.lock:
                busy = conn.job_active or bool(conn.pending) or conn.queued
            if busy or conn.writes_queued:
                continue
            self.idle_closed += 1
            if self._admission is not None:
                self._admission.count_shed("idle")
            self._close_conn(conn)

    def _on_readable(self, conn: _Conn) -> None:
        got_bytes = False
        try:
            while True:
                try:
                    chunk = conn.sock.recv(_RECV_CHUNK)
                except BlockingIOError:
                    break
                if not chunk:
                    conn.read_eof = True
                    break
                conn.inbuf += chunk
                got_bytes = True
        except OSError:
            self._close_conn(conn)
            return
        if got_bytes:
            conn.last_activity = time.monotonic()
        self._parse_requests(conn)
        if conn.dead:
            return
        if conn.read_eof:
            conn.close_after = True
        self._update_interest(conn)
        self._maybe_close(conn)

    def _parse_requests(self, conn: _Conn) -> None:
        """Carve every complete request out of the connection buffer —
        the whole pipelined backlog lands as one worker batch. Each
        request tuple carries a ``pre`` slot: a response the IO thread
        already rendered (inline healthz, admission shed) that the
        emitter uses instead of calling the handler."""
        if conn.stream:
            # a claimed stream connection is write-only from our side;
            # anything else the client sends is protocol noise
            conn.inbuf.clear()
            return
        batch: list = []
        while True:
            if conn.req_head is None:
                idx = conn.inbuf.find(b"\r\n\r\n", conn.scan_from)
                if idx < 0:
                    if len(conn.inbuf) > _MAX_HEADER_BYTES:
                        self._reject(conn, 431)
                        return
                    conn.scan_from = max(0, len(conn.inbuf) - 3)
                    break
                if not self._parse_head(conn, bytes(conn.inbuf[:idx])):
                    return  # rejected
                conn.head_end = idx + 4
            total = conn.head_end + conn.body_len
            if len(conn.inbuf) < total:
                break
            body = bytes(conn.inbuf[conn.head_end:total])
            del conn.inbuf[:total]
            conn.scan_from = 0
            method, target, headers, keep = conn.req_head
            conn.req_head = None
            conn.head_end = None
            conn.body_len = 0
            if self._stream is not None:
                try:
                    claimed = self._stream(method, target, headers)
                except Exception:
                    claimed = None
                if claimed is not None:
                    with conn.lock:
                        quiet = (not batch and not conn.pending
                                 and not conn.job_active and not conn.queued)
                    if not quiet:
                        # a stream upgrade pipelined behind ordinary
                        # requests would interleave frames with their
                        # responses — refuse it deterministically
                        self._reject(conn, 400)
                        return
                    self._begin_stream(conn, *claimed)
                    return
            batch.append((
                method, target, headers, body, keep,
                self._pre_answer(method, target, headers, keep),
            ))
            if not keep:
                # the client promised no more requests on this socket
                conn.inbuf.clear()
                conn.read_eof = True
                break
        if batch:
            self._dispatch_batch(conn, batch)

    def _begin_stream(self, conn: _Conn, status: int, ctype: str,
                      attach) -> None:
        """Upgrade a quiet connection to a long-lived stream: send a
        headers-only response (no Content-Length — the client reads
        until close), mark the connection so the parser and the idle
        reaper leave it alone, and hand the publisher its handle. Read
        interest stays on so a client disconnect is noticed promptly
        (recv EOF → close → the handle's next send returns False)."""
        conn.stream = True
        conn.inbuf.clear()
        conn.scan_from = 0
        head = (
            f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}\r\n"
            f"Content-Type: {ctype}\r\n"
            "Cache-Control: no-store\r\n"
            "Connection: close\r\n"
            "\r\n"
        ).encode("latin-1")
        self._enqueue_write(conn, head, False)
        self.streams_opened += 1
        if attach is not None:
            try:
                attach(StreamHandle(self, conn))
            except Exception:
                self._enqueue_write(conn, b"", True)

    def _pre_answer(self, method, target, headers, keep) -> bytes | None:
        """IO-thread fast path for one parsed request: an inline answer
        (healthz — no worker hop) or an admission shed (expired
        deadline, over-rate tenant, priority). None = needs a worker."""
        if self._inline is not None:
            try:
                answered = self._inline(method, target, headers)
            except Exception:
                answered = None
            if answered is not None:
                status, ctype, payload = answered
                self.inline_served += 1
                return render_response(
                    status, ctype, payload, close=not keep
                )
        adm = self._admission
        if adm is not None:
            decision = adm.classify(method, target, headers)
            if decision is not None:
                adm.count_shed(decision.reason)
                return render_shed(
                    decision.status, decision.reason,
                    decision.retry_after_s, close=not keep,
                )
        return None

    def _dispatch_batch(self, conn: _Conn, batch: list) -> None:
        """Hand a parsed batch to its emitter. All-pre batches on a
        quiet connection are emitted straight from the IO thread via
        the write FIFO (no worker, no admission slot — this is what
        keeps /healthz green with a wedged pool); anything else joins
        ``pending`` and takes the worker path, gated by admission."""
        adm = self._admission
        with conn.lock:
            if (
                not conn.pending and not conn.job_active and not conn.queued
                and all(t[5] is not None for t in batch)
            ):
                out = b"".join(t[5] for t in batch)
                close = any(not t[4] for t in batch)
                self._enqueue_write(conn, out, close)
                return
            conn.pending.extend(batch)
            if conn.job_active or conn.queued:
                return  # the running job / future slot will consume it
            if adm is None or adm.acquire():
                conn.job_active = True
                try:
                    self._pool.submit(self._conn_job, conn)
                except RuntimeError:  # pool shut down mid-stop
                    conn.job_active = False
                    if adm is not None:
                        adm.finish()
                return
            from .overload import request_tenant

            if adm.queue(request_tenant(batch[0][2]), conn):
                conn.queued = True
                return
            # tenant queue full: shed the whole backlog, 503 each
            backlog, conn.pending = conn.pending, []
        out = bytearray()
        close = False
        for _m, _t, _h, _b, keep, pre in backlog:
            if pre is not None:
                out += pre  # already answered (inline / earlier shed)
            else:
                adm.count_shed("queue_full")
                out += render_shed(
                    503, "queue_full", adm.retry_after_s, close=not keep
                )
            if not keep:
                close = True
        self._enqueue_write(conn, bytes(out), close)

    def _parse_head(self, conn: _Conn, head: bytes) -> bool:
        try:
            lines = head.split(b"\r\n")
            method_b, target_b, version_b = lines[0].split(b" ", 2)
            method = method_b.decode("latin-1")
            target = target_b.decode("latin-1")
            version = version_b.decode("latin-1").strip()
            headers: dict[str, str] = {}
            for line in lines[1:]:
                if not line:
                    continue
                name, sep, value = line.partition(b":")
                if not sep:
                    raise ValueError("malformed header line")
                headers[name.decode("latin-1").strip().lower()] = (
                    value.decode("latin-1").strip()
                )
        except (ValueError, UnicodeDecodeError):
            self._reject(conn, 400)
            return False
        if headers.get("transfer-encoding"):
            self._reject(conn, 501)
            return False
        try:
            body_len = int(headers.get("content-length") or 0)
        except ValueError:
            self._reject(conn, 400)
            return False
        if body_len < 0:
            self._reject(conn, 400)
            return False
        if body_len > _MAX_BODY_BYTES:
            self._reject(conn, 413)
            return False
        conn_hdr = headers.get("connection", "").lower()
        if version == "HTTP/1.0":
            keep = "keep-alive" in conn_hdr
        else:
            keep = "close" not in conn_hdr
        conn.req_head = (method, target, headers, keep)
        conn.body_len = body_len
        return True

    def _reject(self, conn: _Conn, status: int) -> None:
        """Protocol-level error: answer and drop the connection (IO
        thread context — write directly, no worker round-trip)."""
        body = b'{"error": "bad request"}'
        conn.outbuf += render_response(
            status, "application/json", body, close=True
        )
        conn.inbuf.clear()
        conn.read_eof = True
        conn.close_after = True
        self._flush(conn)

    # -- worker side -------------------------------------------------------

    def _conn_job(self, conn: _Conn) -> None:
        handler = self._handler
        while True:
            with conn.lock:
                batch = conn.pending
                if not batch:
                    conn.job_active = False
                    if conn.close_after:
                        # the IO thread may have seen job_active=True and
                        # skipped the close — nudge it to re-check
                        self._enqueue_write(conn, b"", False)
                    break
                conn.pending = []
            out = bytearray()
            close = False
            for method, target, headers, body, keep, pre in batch:
                if pre is not None:
                    # answered on the IO thread; emit in request order
                    out += pre
                    if not keep:
                        close = True
                    continue
                try:
                    status, ctype, payload = handler(
                        method, target, headers, body
                    )
                except Exception:
                    status, ctype, payload = (
                        500, "application/json", b'{"error": "internal error"}'
                    )
                if not keep:
                    close = True
                out += render_response(status, ctype, payload, close=not keep)
            self._enqueue_write(conn, bytes(out), close)
            if close:
                with conn.lock:
                    conn.job_active = False
                break
        self._job_done()

    def _job_done(self) -> None:
        """This job's admission slot is free — hand it, weighted-fair,
        to the next parked connection (skipping ones that died while
        waiting)."""
        adm = self._admission
        if adm is None:
            return
        nxt = adm.finish()
        while nxt is not None:
            submit = False
            with nxt.lock:
                nxt.queued = False
                if not nxt.dead and nxt.pending and not nxt.job_active:
                    nxt.job_active = True
                    submit = True
            if submit:
                try:
                    self._pool.submit(self._conn_job, nxt)
                except RuntimeError:  # pool shut down mid-stop
                    with nxt.lock:
                        nxt.job_active = False
                    adm.finish()
                return
            nxt = adm.abandon()

    def _enqueue_write(self, conn: _Conn, data: bytes, close: bool) -> None:
        with self._writes_lock:
            conn.writes_queued += 1
            self._writes.append((conn, data, close))
        self._wakeup()

    def _drain_writes(self) -> None:
        while True:
            with self._writes_lock:
                if not self._writes:
                    return
                conn, data, close = self._writes.popleft()
                conn.writes_queued -= 1
            if conn.dead:
                continue
            conn.outbuf += data
            if close:
                conn.close_after = True
            self._flush(conn)

    # -- write path (IO thread) --------------------------------------------

    def _flush(self, conn: _Conn) -> None:
        try:
            while conn.outbuf:
                sent = conn.sock.send(conn.outbuf)
                del conn.outbuf[:sent]
                if sent:
                    # send progress counts as activity: a slow-but-live
                    # reader is not the reaper's business
                    conn.last_activity = time.monotonic()
        except BlockingIOError:
            pass
        except OSError:
            self._close_conn(conn)
            return
        self._update_interest(conn)
        self._maybe_close(conn)

    def _update_interest(self, conn: _Conn) -> None:
        if conn.dead:
            return
        events = 0
        if not conn.read_eof:
            events |= selectors.EVENT_READ
        if conn.outbuf:
            events |= selectors.EVENT_WRITE
        if events == conn.registered:
            return
        try:
            if conn.registered == 0:
                if events:
                    self._sel.register(conn.sock, events, conn)
            elif events == 0:
                self._sel.unregister(conn.sock)
            else:
                self._sel.modify(conn.sock, events, conn)
        except (KeyError, ValueError, OSError):
            pass
        conn.registered = events

    def _maybe_close(self, conn: _Conn) -> None:
        if conn.dead or not conn.close_after or conn.outbuf:
            return
        with conn.lock:
            busy = conn.job_active or bool(conn.pending)
        # a finished job may have handed its response to _writes but not
        # yet been drained into outbuf — closing now would drop it
        if not busy and not conn.writes_queued:
            self._close_conn(conn)

    def _close_conn(self, conn: _Conn) -> None:
        if conn.dead:
            return
        conn.dead = True
        if conn.registered:
            try:
                self._sel.unregister(conn.sock)
            except (KeyError, ValueError, OSError):
                pass
            conn.registered = 0
        self._conns.pop(conn.fd, None)
        try:
            conn.sock.close()
        except OSError:
            pass
