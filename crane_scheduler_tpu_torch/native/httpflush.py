"""The host library's HTTP flush engines: a GIL-free fan-out of
pre-rendered requests.

Copy of ``crane_scheduler_tpu/native/httpflush.py``. The reference's
annotation writes go through client-go from compiled Go
(ref: pkg/controller/annotator/node.go:123-146), so framing, response
parsing and connection pooling never touch an interpreter lock. This
wrapper hands a whole batch of pre-rendered HTTP/1.1 requests to
``crane_http_flush`` or ``crane_http_flush_pipelined``
(``csrc/crane_native.cpp``): C++ worker threads send, parse and drain over
keep-alive connections while the one ctypes call releases the GIL.

Plain http over IPv4 only. TLS and small batches ride the Python routes in
``cluster/kube.py``, which also own status-based retry and backoff: this
engine retries only at the transport level and reports per-request
statuses for the caller to triage.
"""

from __future__ import annotations

import ctypes
import socket

import numpy as np

from .lib import load_native

_P_I32 = ctypes.POINTER(ctypes.c_int32)
_P_I64 = ctypes.POINTER(ctypes.c_int64)


class NativeHTTPFlusher:
    def __init__(self, host: str, port: int, workers: int = 8,
                 timeout: float = 30.0, pipeline_depth: int = 8):
        self._lib = load_native()
        self._host = host
        self._port = int(port)
        self._workers = int(workers)
        self._timeout_ms = max(1, int(timeout * 1000))
        self._pipeline_depth = max(1, int(pipeline_depth))
        # cumulative pipelined-engine counters (the kube client folds
        # them into telemetry after each flush)
        self.last_stats = {"stalls": 0, "indeterminate": 0, "reconnects": 0, "sends": 0}
        # the C engine takes an IPv4 literal: resolved up front, and
        # re-resolved when a whole batch comes back transport-dead (DNS
        # failover moved the apiserver while the client keeps this
        # flusher for its lifetime)
        self._ip = self._resolve()

    def _resolve(self) -> bytes:
        """First A record for the host via getaddrinfo (``/etc/hosts``,
        round-robin DNS and IPv4 literals alike). An AAAA-only host fails
        here with ``OSError``."""
        infos = socket.getaddrinfo(self._host, self._port, socket.AF_INET,
                                   socket.SOCK_STREAM)
        if not infos:
            raise OSError(f"no IPv4 address for {self._host!r}")
        return infos[0][4][0].encode("ascii")

    @staticmethod
    def _blob(requests: list[bytes]) -> tuple[bytes, np.ndarray]:
        offsets = np.zeros(len(requests) + 1, np.int64)
        np.cumsum([len(r) for r in requests], out=offsets[1:])
        return b"".join(requests), offsets

    def _after_batch(self, statuses: np.ndarray) -> None:
        if not statuses.any():
            # every request died at the transport layer: the cached IPv4
            # is suspect (apiserver failover). Re-resolve for the next
            # batch; keep the old address when resolution itself fails,
            # so a transient DNS outage cannot lose a working target.
            try:
                self._ip = self._resolve()
            except OSError:
                pass

    def flush(self, requests: list[bytes], idempotent: bool = True) -> np.ndarray:
        """Send every request; return the per-request HTTP statuses
        (0 = transport failure after the engine's own retry policy:
        send-phase failures retry once for all methods, response-phase
        failures only when ``idempotent``)."""
        n = len(requests)
        statuses = np.zeros(n, np.int32)
        if n == 0:
            return statuses
        blob, offsets = self._blob(requests)
        self._lib.crane_http_flush(
            self._ip, self._port, blob, offsets.ctypes.data_as(_P_I64), n,
            self._workers, 1 if idempotent else 0, self._timeout_ms,
            statuses.ctypes.data_as(_P_I32),
        )
        self._after_batch(statuses)
        return statuses

    def flush_pipelined(self, requests: list[bytes], idempotent: bool = True,
                        depth: int | None = None, conns: int | None = None) -> np.ndarray:
        """Pipelined fan-out: ``conns`` keep-alive connections, up to
        ``depth`` requests in flight per connection (responses accounted
        strictly in order), fill phases coalesced into single sends.
        Status 0 = transport failure or indeterminate: for non-idempotent
        batches a response-phase loss marks the awaited request and
        everything already pipelined behind it on that connection
        indeterminate, and the engine never re-POSTs them (the server may
        have processed any prefix); idempotent batches retry the same set
        once. Engine counters land in ``last_stats``."""
        n = len(requests)
        statuses = np.zeros(n, np.int32)
        if n == 0:
            return statuses
        blob, offsets = self._blob(requests)
        stats = np.zeros(4, np.int64)
        self._lib.crane_http_flush_pipelined(
            self._ip, self._port, blob, offsets.ctypes.data_as(_P_I64), n,
            conns or self._workers, depth or self._pipeline_depth,
            1 if idempotent else 0, self._timeout_ms,
            statuses.ctypes.data_as(_P_I32), stats.ctypes.data_as(_P_I64),
        )
        for i, key in enumerate(("stalls", "indeterminate", "reconnects", "sends")):
            self.last_stats[key] += int(stats[i])
        self._after_batch(statuses)
        return statuses
