"""Mirror delta-stream replication: the versioned-log substrate v1.

Copy of ``crane_scheduler_tpu/cluster/replication.py``, over the port's
``ClusterState``: frames are the reference's bytes exactly (canonical
JSON, the same header), so a port replica can follow a reference primary
and the other way round.

The blueprint paper's central idea — decouple the metrics-sync path
from the scheduling/serving hot path via versioned state hand-off —
lands here as wire-shipped state: a primary process that owns the
authoritative ``ClusterState`` publishes **version-keyed, named-key
deltas**, and any number of shared-nothing serving replicas ingest the
delta stream into their own mirror instead of each running a LIST+watch
against the apiserver (N replicas must not multiply apiserver read
load; doc/replication.md). The framing rides the write path's
discipline: length-prefixed, checksummed frames that a torn tail can
never half-apply, and a per-consumer fence (the version cursor) that
makes resume exact.

Three pieces:

- ``encode_frame`` / ``DeltaDecoder`` — the wire format. One frame is
  ``MAGIC | u32 length | u32 crc32 | payload`` (payload = canonical
  JSON). The decoder buffers arbitrary kernel-torn byte arrivals and
  yields only complete, checksum-verified frames; a partial tail stays
  buffered (or is dropped with the connection), so a delta either
  applies whole or not at all.

- ``DeltaPublisher`` — diffs the authoritative cluster against its
  last-published shadow once per version window and ships ONE delta
  frame per window: ``{from, v, nodes: {name: annotations | null}}``
  (null = node deleted). Deltas are named-key (keyed by node name, the
  same key discipline as the store's named writes), so windows coalesce
  naturally: ten sweeps inside one window ship as one frame with each
  node's newest value. A bounded ring of recent frames lets a consumer
  resume from its fence; a consumer behind the ring floor gets a
  snapshot frame (``snap: true``) and continues live from there.

- ``ReplicaMirror`` / ``DeltaStreamClient`` — the consumer side. The
  mirror owns a private ``ClusterState`` and applies each frame as one
  transaction; ``applied_version`` is the fence. A frame whose ``from``
  does not equal the fence is a **version gap** (`VersionGapError`):
  the client drops the stream and reconnects with its cursor, which the
  publisher answers with ring replay or a snapshot — resume is always
  cursor-exact, never "hope the stream was contiguous".

Metrics (doc/observability.md): ``crane_replica_deltas_applied_total``,
``crane_replica_snapshots_total``, ``crane_replica_gaps_total``,
``crane_replica_lag_versions``, ``crane_replica_feed_connected``,
``crane_replication_published_version``, ``crane_replication_consumers``.
Stdlib + the in-repo cluster model only.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time
import zlib
from collections import deque
from typing import Callable, Mapping

from .state import ClusterState, Node

FRAME_MAGIC = b"CRDL"
_HEADER = struct.Struct(">II")  # payload length, crc32(payload)
_MAX_FRAME_BYTES = 256 << 20  # a 1M-node snapshot fits well under this

FEED_PATH = "/v1/replication/feed"
FEED_CONTENT_TYPE = "application/x-crane-delta-stream"


class FrameError(Exception):
    """The byte stream is not a valid frame sequence (bad magic, crc
    mismatch, or an absurd length): the connection is poisoned and the
    consumer must resync by reconnecting from its cursor."""


class VersionGapError(Exception):
    """A delta's ``from`` fence does not match the mirror's cursor —
    applying it could tear the mirror. The consumer reconnects with its
    cursor; the publisher answers with replay or a snapshot."""

    def __init__(self, expected: int, got: int):
        super().__init__(
            f"delta stream gap: mirror fence {expected}, frame from {got}"
        )
        self.expected = expected
        self.got = got


def encode_frame(payload: dict) -> bytes:
    """One wire frame: canonical JSON behind a length + crc32 header.
    ``sort_keys`` keeps the encoding deterministic, so identical deltas
    are identical bytes (the byte-identity discipline end to end)."""
    body = json.dumps(payload, sort_keys=True, separators=(",", ":")).encode()
    return FRAME_MAGIC + _HEADER.pack(len(body), zlib.crc32(body)) + body


class DeltaDecoder:
    """Incremental frame parser over kernel-torn byte arrivals (the
    watch-stream discipline): bytes accumulate however they arrive, and
    ``feed`` yields every COMPLETE checksum-verified frame. A torn tail
    stays buffered until its remainder arrives or the connection dies —
    it can never be half-applied."""

    __slots__ = ("_buf",)

    def __init__(self):
        self._buf = bytearray()

    @property
    def pending_bytes(self) -> int:
        return len(self._buf)

    def feed(self, data: bytes) -> list[dict]:
        self._buf += data
        frames: list[dict] = []
        buf = self._buf
        head = len(FRAME_MAGIC) + _HEADER.size
        while len(buf) >= head:
            if buf[: len(FRAME_MAGIC)] != FRAME_MAGIC:
                raise FrameError("bad frame magic")
            length, crc = _HEADER.unpack_from(buf, len(FRAME_MAGIC))
            if length > _MAX_FRAME_BYTES:
                raise FrameError(f"frame length {length} over cap")
            total = head + length
            if len(buf) < total:
                break  # torn tail: wait for the rest
            body = bytes(buf[head:total])
            if zlib.crc32(body) != crc:
                raise FrameError("frame crc mismatch")
            del buf[:total]
            try:
                frames.append(json.loads(body))
            except ValueError as e:  # pragma: no cover - crc caught it
                raise FrameError(f"frame payload not JSON: {e}") from e
        return frames


class _Consumer:
    """One attached feed connection: a send callable plus its fence."""

    __slots__ = ("send", "fence", "name")

    def __init__(self, send: Callable[[bytes], bool], fence: int, name: str):
        self.send = send
        self.fence = fence
        self.name = name


class DeltaPublisher:
    """The primary-side delta source over an authoritative cluster.

    ``publish_window()`` is the one state-advancing step: diff the
    cluster against the published shadow, ship one frame to every
    attached consumer, retain the frame in the resume ring. It is safe
    to call from a timer thread (``start``) or directly (tests, bench —
    deterministic windows). Consumers attach via ``subscribe`` with
    their cursor; catch-up (ring replay or snapshot) happens inside the
    subscribe call, so a consumer is live-consistent the moment it is
    attached."""

    def __init__(
        self,
        cluster: ClusterState,
        *,
        window_s: float = 0.05,
        ring_frames: int = 128,
        telemetry=None,
    ):
        self.cluster = cluster
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        # name -> annotations mapping of the last published state;
        # sweeps replace whole mapping objects, so the diff is an
        # identity check per node with an equality fallback
        self._shadow: dict[str, Mapping[str, str]] = {}
        self._published_version = -1
        self._ring: deque[tuple[int, int, bytes]] = deque(maxlen=ring_frames)
        self._consumers: list[_Consumer] = []
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.stats = {"windows": 0, "frames_sent": 0, "snapshots_sent": 0}
        self._m_published = self._m_consumers = None
        if telemetry is not None:
            reg = telemetry.registry
            self._m_published = reg.gauge(
                "crane_replication_published_version",
                "Version fence of the last published delta window",
            )
            self._m_consumers = reg.gauge(
                "crane_replication_consumers",
                "Feed connections currently attached",
            )

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="crane-delta-pub", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        with self._lock:
            consumers, self._consumers = self._consumers, []
        for c in consumers:
            try:
                c.send(b"")
            except Exception:
                pass

    def _run(self) -> None:
        while not self._stop.wait(self.window_s):
            try:
                self.publish_window()
            except Exception:  # pragma: no cover - keep the feed alive
                pass

    # -- publishing ---------------------------------------------------------

    @property
    def published_version(self) -> int:
        with self._lock:
            return self._published_version

    def _cluster_version(self) -> int:
        return self.cluster.node_version

    def publish_window(self) -> int:
        """Diff + ship one version window. Returns the number of changed
        names shipped (0 = quiet window, nothing sent — a quiet stream
        is normal and must not reset consumer liveness)."""
        with self._lock:
            nodes = self.cluster.list_nodes()
            version = self._cluster_version()
            shadow = self._shadow
            changed: dict[str, dict[str, str] | None] = {}
            seen = set()
            for node in nodes:
                name = node.name
                seen.add(name)
                prev = shadow.get(name)
                anno = node.annotations
                if prev is None or (prev is not anno and prev != anno):
                    changed[name] = dict(anno)
            for name in shadow.keys() - seen:
                changed[name] = None
            self.stats["windows"] += 1
            if not changed and self._published_version >= 0:
                return 0
            frame = encode_frame({
                "from": self._published_version,
                "v": version,
                "nodes": changed,
            })
            self._ring.append((self._published_version, version, frame))
            for name, anno in changed.items():
                if anno is None:
                    shadow.pop(name, None)
                else:
                    # keep the live node's mapping object so the next
                    # window's identity check short-circuits
                    shadow[name] = anno
            self._published_version = version
            consumers = list(self._consumers)
        if self._m_published is not None:
            self._m_published.set(version)
        dead: list[_Consumer] = []
        for c in consumers:
            if c.send(frame):
                c.fence = version
                self.stats["frames_sent"] += 1
            else:
                dead.append(c)
        if dead:
            with self._lock:
                for c in dead:
                    try:
                        self._consumers.remove(c)
                    except ValueError:
                        pass
            self._note_consumers()
        return len(changed)

    def _snapshot_frame_locked(self) -> bytes:
        return encode_frame({
            "from": -1,
            "v": self._published_version,
            "snap": True,
            "nodes": {n: dict(a) for n, a in self._shadow.items()},
        })

    def _note_consumers(self) -> None:
        if self._m_consumers is not None:
            with self._lock:
                n = len(self._consumers)
            self._m_consumers.set(n)

    # -- consumers ----------------------------------------------------------

    def subscribe(
        self, send: Callable[[bytes], bool], from_version: int,
        name: str = "",
    ) -> int:
        """Attach a consumer whose fence is ``from_version``. Catch-up
        is decided here, under the lock, so no window can slip between
        catch-up and live attachment: ring replay when the cursor is
        inside the retained ring, a snapshot frame otherwise. Returns
        the consumer's fence after catch-up."""
        with self._lock:
            current = self._published_version
            catchup: list[bytes] = []
            snapshot = False
            if from_version == current:
                fence = current
            elif from_version > current:
                # the consumer is AHEAD of us (publisher restart lost
                # the shadow): only a snapshot can make it consistent
                catchup = [self._snapshot_frame_locked()]
                fence = current
                self.stats["snapshots_sent"] += 1
            else:
                replay = [
                    (f, t, frame) for f, t, frame in self._ring
                    if f >= from_version
                ]
                if replay and replay[0][0] == from_version:
                    fence = from_version
                    for f, t, frame in replay:
                        if f == fence:
                            catchup.append(frame)
                            fence = t
                    snapshot = fence != current
                else:
                    snapshot = True
                if snapshot:
                    catchup = [self._snapshot_frame_locked()]
                    fence = current
                    self.stats["snapshots_sent"] += 1
            consumer = _Consumer(send, fence, name)
            self._consumers.append(consumer)
        for frame in catchup:
            if not consumer.send(frame):
                with self._lock:
                    try:
                        self._consumers.remove(consumer)
                    except ValueError:
                        pass
                break
            self.stats["frames_sent"] += 1
        self._note_consumers()
        return consumer.fence

    def unsubscribe(self, send: Callable[[bytes], bool]) -> None:
        with self._lock:
            self._consumers = [c for c in self._consumers if c.send is not send]
        self._note_consumers()

    @property
    def consumer_count(self) -> int:
        with self._lock:
            return len(self._consumers)

    # -- async front-end stream glue ---------------------------------------

    def stream_handler(self, method: str, target: str, headers):
        """``AsyncHTTPServer`` stream-route hook: claim GET requests on
        ``/v1/replication/feed`` as long-lived delta streams. Returns
        ``(status, content_type, attach)`` or None (not ours)."""
        path, _, query = target.partition("?")
        if method != "GET" or path != FEED_PATH:
            return None

        from urllib.parse import parse_qs

        try:
            raw = parse_qs(query).get("from", ["-1"])[0]
            cursor = int(raw)
        except (ValueError, TypeError):
            cursor = -1

        def attach(handle) -> None:
            self.subscribe(handle.send, cursor, name=f"fd{handle.fd}")

        return 200, FEED_CONTENT_TYPE, attach

    def status(self) -> dict:
        with self._lock:
            return {
                "publishedVersion": self._published_version,
                "consumers": len(self._consumers),
                "windows": self.stats["windows"],
                "framesSent": self.stats["frames_sent"],
                "snapshotsSent": self.stats["snapshots_sent"],
                "ringFrames": len(self._ring),
            }


class ReplicaMirror:
    """A replica's private cluster mirror fed exclusively by delta
    frames. ``applied_version`` is the per-consumer fence: every frame
    applies as one ``ClusterState`` transaction keyed by it, so a
    mirror is always AT a published version, never between two."""

    def __init__(self, telemetry=None):
        self.cluster = ClusterState()
        self._lock = threading.Lock()
        self._applied_version = -1
        self._published_hint = -1
        self.stats = {"deltas": 0, "snapshots": 0, "gaps": 0, "nodes": 0}
        self._m_applied = None
        if telemetry is not None:
            reg = telemetry.registry
            self._m_deltas = reg.counter(
                "crane_replica_deltas_applied_total",
                "Delta frames applied to the mirror",
            )
            self._m_snapshots = reg.counter(
                "crane_replica_snapshots_total",
                "Snapshot frames applied (restart / out-of-ring resume)",
            )
            self._m_gaps = reg.counter(
                "crane_replica_gaps_total",
                "Version gaps detected (frame fence != mirror cursor)",
            )
            self._m_lag = reg.gauge(
                "crane_replica_lag_versions",
                "Published version minus the mirror's applied version",
            )
            self._m_applied = reg.gauge(
                "crane_replica_applied_version",
                "The mirror's applied version fence",
            )

    @property
    def applied_version(self) -> int:
        with self._lock:
            return self._applied_version

    @property
    def published_hint(self) -> int:
        """The newest published version this mirror has SEEN (frames
        carry it); lag accounting against a live primary should prefer
        the primary's own status over this hint."""
        with self._lock:
            return self._published_hint

    @property
    def lag_versions(self) -> int:
        with self._lock:
            return max(0, self._published_hint - self._applied_version)

    def note_published(self, version: int) -> None:
        """Fold an externally learned published version into the lag
        hint (the feed client calls this per frame; a status prober may
        too)."""
        with self._lock:
            if version > self._published_hint:
                self._published_hint = version
        if self._m_applied is not None:
            self._m_lag.set(self.lag_versions)

    def apply_frame(self, frame: dict) -> int:
        """Apply one decoded frame as one mirror transaction. Returns
        the number of node rows touched. Raises ``VersionGapError``
        when the frame's fence does not match the cursor (the caller
        resyncs by reconnecting from the cursor)."""
        nodes = frame.get("nodes") or {}
        version = int(frame.get("v", -1))
        snap = bool(frame.get("snap"))
        with self._lock:
            if snap:
                self.cluster.replace_nodes(
                    Node(name=name, annotations=anno)
                    for name, anno in nodes.items()
                    if anno is not None
                )
                self.stats["snapshots"] += 1
            else:
                if int(frame.get("from", -2)) != self._applied_version:
                    self.stats["gaps"] += 1
                    if self._m_applied is not None:
                        self._m_gaps.inc()
                    raise VersionGapError(
                        self._applied_version, int(frame.get("from", -2))
                    )
                self.cluster.apply_node_changes(
                    ("DELETED", Node(name=name)) if anno is None
                    else ("MODIFIED", Node(name=name, annotations=anno))
                    for name, anno in nodes.items()
                )
                self.stats["deltas"] += 1
            self._applied_version = version
            if version > self._published_hint:
                self._published_hint = version
            self.stats["nodes"] += len(nodes)
        if self._m_applied is not None:
            if snap:
                self._m_snapshots.inc()
            else:
                self._m_deltas.inc()
            self._m_applied.set(version)
            self._m_lag.set(self.lag_versions)
        return len(nodes)

    def status(self) -> dict:
        with self._lock:
            return {
                "appliedVersion": self._applied_version,
                "publishedHint": self._published_hint,
                "lagVersions": max(
                    0, self._published_hint - self._applied_version
                ),
                "deltasApplied": self.stats["deltas"],
                "snapshotsApplied": self.stats["snapshots"],
                "gaps": self.stats["gaps"],
                "nodes": len(self.cluster.list_nodes()),
            }


class DeltaStreamClient:
    """The replica's feed connection: one background thread that keeps
    a ``GET /v1/replication/feed?from=<cursor>`` stream open against
    the primary, decodes frames, and applies them to the mirror.

    Resume discipline: ANY stream failure — socket death, torn tail,
    frame corruption, version gap — tears down the connection and
    reconnects with ``from=<applied_version>``; the publisher answers
    with ring replay or a snapshot. The mirror can therefore never be
    torn: frames apply whole, and the cursor only moves on a whole
    frame."""

    def __init__(
        self,
        host: str,
        port: int,
        mirror: ReplicaMirror,
        *,
        telemetry=None,
        reconnect_backoff_s: float = 0.05,
        max_backoff_s: float = 1.0,
        read_timeout_s: float = 2.0,
    ):
        self.host = host
        self.port = int(port)
        self.mirror = mirror
        self.backoff_s = float(reconnect_backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.read_timeout_s = float(read_timeout_s)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._connected = threading.Event()
        self._applied_any = threading.Event()
        self.stats = {"connects": 0, "resumes": 0, "stream_errors": 0}
        self._m_connected = None
        if telemetry is not None:
            reg = telemetry.registry
            self._m_connected = reg.gauge(
                "crane_replica_feed_connected",
                "1 while the delta-stream connection is established",
            )
            self._m_resumes = reg.counter(
                "crane_replica_feed_resumes_total",
                "Feed reconnects carrying a non-initial cursor",
            )

    @property
    def connected(self) -> bool:
        return self._connected.is_set()

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="crane-delta-feed", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def wait_caught_up(self, version: int, timeout_s: float = 10.0) -> bool:
        """Block until the mirror's fence reaches ``version``."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.mirror.applied_version >= version:
                return True
            time.sleep(0.005)
        return self.mirror.applied_version >= version

    def _run(self) -> None:
        backoff = self.backoff_s
        while not self._stop.is_set():
            try:
                self._stream_once()
                backoff = self.backoff_s  # clean teardown: reset
            except Exception:
                self.stats["stream_errors"] += 1
            if self._stop.is_set():
                break
            self._stop.wait(backoff)
            backoff = min(self.max_backoff_s, backoff * 2)

    def _stream_once(self) -> None:
        cursor = self.mirror.applied_version
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.read_timeout_s
        )
        try:
            sock.settimeout(self.read_timeout_s)
            request = (
                f"GET {FEED_PATH}?from={cursor} HTTP/1.1\r\n"
                f"Host: {self.host}:{self.port}\r\n"
                "\r\n"
            ).encode("latin-1")
            sock.sendall(request)
            head = bytearray()
            while b"\r\n\r\n" not in head:
                chunk = sock.recv(4096)
                if not chunk:
                    raise ConnectionError("feed closed during head")
                head += chunk
                if len(head) > 64 * 1024:
                    raise FrameError("feed response head too large")
            head_bytes, _, rest = bytes(head).partition(b"\r\n\r\n")
            status_line = head_bytes.split(b"\r\n", 1)[0]
            if b" 200 " not in status_line + b" ":
                raise ConnectionError(
                    f"feed rejected: {status_line.decode('latin-1')!r}"
                )
            self.stats["connects"] += 1
            if cursor >= 0:
                self.stats["resumes"] += 1
                if self._m_connected is not None:
                    self._m_resumes.inc()
            self._connected.set()
            if self._m_connected is not None:
                self._m_connected.set(1)
            decoder = DeltaDecoder()
            data = rest
            while not self._stop.is_set():
                if data:
                    for frame in decoder.feed(data):
                        self.mirror.apply_frame(frame)
                        self._applied_any.set()
                try:
                    data = sock.recv(1 << 16)
                except socket.timeout:
                    data = b""
                    continue
                if not data:
                    raise ConnectionError("feed closed")
        finally:
            self._connected.clear()
            if self._m_connected is not None:
                self._m_connected.set(0)
            try:
                sock.close()
            except OSError:
                pass
