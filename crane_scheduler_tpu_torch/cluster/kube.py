"""Kubernetes apiserver client: the deployment-grade ClusterState.

Counterpart of ``crane_scheduler_tpu/cluster/kube.py`` (``KubeClusterClient``);
the wire layer it stands on is ``cluster/kube_wire.py``. The reference
coordinates everything through the kube-apiserver: client-go informers
for reads, JSON merge-patches for annotation writes
(ref: pkg/controller/annotator/node.go:123-146), the pod ``binding``
subresource for binds, and a server-side-filtered Event watch
(ref: cmd/controller/app/options/factory.go:25-33). This is the same
architecture in stdlib Python:

- **Reads are informer-style**: background watch threads mirror nodes,
  pods, events and NodeResourceTopology CRs into an in-memory
  ``ClusterState``; every consumer (annotator, scheduler, store refresh)
  reads the mirror exactly as it reads the simulator's cluster. LIST pages
  decode through ``native.listdecode`` (paginated, the next page
  prefetched while one decodes); watch streams are drained per wakeup and
  applied as one mirror transaction per drained batch.
- **Writes go through the API**: annotation merge-patches, the ``binding``
  and ``eviction`` subresources, pod creation. The mirror applies each
  accepted write optimistically (binds with ``notify=False``: the
  apiserver's Scheduled events arrive through the event watch). Writes
  ride a pool of ``concurrent_syncs`` keep-alive workers routed by object
  key; batches of 64 or more ride the pipelined multi-connection flush
  (``_pipelined_flush``) with the reference's POST-safety contract.
- **Events**: deduplicated across reconnects and relists by a guarded
  resourceVersion watermark plus a bounded content-key map, so replays
  never double-count hot values.

Crash safety: with an ``IntentJournal`` attached
(``attach_intent_journal``, ``resilience/recovery.py``) every bind and
eviction POST journals its intent before the first byte reaches the
wire and its outcome after (2xx ``ack``, a real status ``nack``, status
0 ``unresolved``); watch confirmations tombstone open intents. The shard
plane's calls (``configure_shards``, ``shard_versions``, ``reshard``,
``dirty_nodes_since(version, shard)``) delegate to the mirror.

Port differences. The native flush engine and the native LIST/watch
decoders come with ``ROADMAP.md`` Queue 1 item 8.4 (the bulk paths here
take the pipelined Python fan-out, the reference's branch when its
library is absent, so the journal covers every batch that route sends;
watch lines take the per-line JSON path). The reference's before/after
comparison switches are left out. ``node_annotation_columns`` stays valid across
annotation-only writes: it patches the relist's columns from the
mirror's dirty-name journal (``ClusterState.node_annotations_since``),
so a refresh after a named patch takes the columnar branch narrowed to
the dirty names (the reference drops the columns at the first write).

Auth: optional bearer token (explicit, from ``--token-file``, or the
in-cluster service-account token) and TLS through ``context``.
"""

from __future__ import annotations

import json
import ssl
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import Future
from typing import Callable
from urllib.parse import urlsplit

import numpy as np

from ..telemetry import Telemetry, active as active_telemetry
from .kube_wire import (
    _PIPELINE_FLUSH_MIN,
    _RETRYABLE_ANY,
    _RETRYABLE_IDEMPOTENT,
    DEFAULT_TIMEOUT_SECONDS,
    NRT_API_PATH,
    NRT_RETRY_SECONDS,
    SERVICE_ACCOUNT_CA,
    SERVICE_ACCOUNT_TOKEN,
    WATCH_TIMEOUT_SECONDS,
    WriteResult,
    _deadline_pair,
    _PooledWriter,
    _RawHTTPConnection,
    _WatchStream,
    event_from_json,
    node_from_json,
    nrt_from_json,
    pod_from_json,
)
from .state import ClusterState, Pod

__all__ = [
    "KubeClusterClient",
    "WriteResult",
    "event_from_json",
    "node_from_json",
    "nrt_from_json",
    "pod_from_json",
]


# requests in flight per connection of the pipelined flush
_PIPELINE_DEPTH = 16
# how long stop() waits for this client's threads, all together
_STOP_JOIN_SECONDS = 10.0


class _KubeBurstHandle:
    """Burst handle pairing the mirror's columnar burst with the rows
    whose creation POST the apiserver refused (never bound)."""

    __slots__ = ("burst", "failed")

    def __init__(self, burst, failed: set):
        self.burst = burst
        self.failed = failed


def _patch_columns(merged, pos, changed):
    """The relist columns ``merged = (names, keys, values, offsets)`` with
    the rows of ``changed`` ({name: annotations}) replaced. Untouched
    spans are copied by slice, so the cost is one pass of list copies
    plus O(changed) Python."""
    names, keys, values, offsets = merged
    lens = np.diff(offsets)
    new_keys: list = []
    new_values: list = []
    prev = 0
    for row in sorted(pos[name] for name in changed):
        a, b = int(offsets[row]), int(offsets[row + 1])
        new_keys.extend(keys[prev:a])
        new_values.extend(values[prev:a])
        anno = changed[names[row]]
        new_keys.extend(anno.keys())
        new_values.extend(anno.values())
        lens[row] = len(anno)
        prev = b
    new_keys.extend(keys[prev:])
    new_values.extend(values[prev:])
    new_offsets = np.zeros(len(names) + 1, dtype=np.int64)
    np.cumsum(lens, out=new_offsets[1:])
    return names, new_keys, new_values, new_offsets


class KubeClusterClient:
    """Informer-backed cluster view + API write-through.

    Drop-in for ``ClusterState`` everywhere the framework reads or
    writes cluster data. ``start()`` performs the initial list and spawns
    the watch threads; ``stop()`` tears them down and joins them. All
    read methods delegate to the internal mirror (including
    ``sched_version`` for the scheduler's snapshot cache and event
    subscription for the annotator), so consumers cannot tell it apart
    from the in-memory cluster.
    """

    @classmethod
    def from_flags(
        cls,
        master: str,
        token_file: str | None = None,
        concurrent_syncs: int = 4,
    ) -> "KubeClusterClient":
        """CLI/in-cluster construction: bearer token from ``token_file``
        or the mounted service-account token, and the in-cluster CA
        bundle when present (the apiserver's cert is signed by the
        cluster CA, not anything in the system trust store)."""
        import os

        token = None
        path = token_file or (
            SERVICE_ACCOUNT_TOKEN if os.path.exists(SERVICE_ACCOUNT_TOKEN) else None
        )
        if path:
            with open(path) as f:
                token = f.read().strip()
        context = None
        if os.path.exists(SERVICE_ACCOUNT_CA):
            context = ssl.create_default_context(cafile=SERVICE_ACCOUNT_CA)
        return cls(master, token=token, context=context,
                   concurrent_syncs=concurrent_syncs)

    def __init__(
        self,
        base_url: str,
        token: str | None = None,
        context: ssl.SSLContext | None = None,
        timeout: float = DEFAULT_TIMEOUT_SECONDS,
        seen_events_cap: int = 65536,
        list_page_limit: int = 500,
        concurrent_syncs: int = 4,
        telemetry: Telemetry | None = None,
        read_breaker=None,
        write_breaker=None,
    ):
        self.base_url = base_url.rstrip("/")
        # per-fault-domain breakers: the read breaker sees one outcome
        # per LIST and per watch-stream iteration, the write breaker one
        # per pooled write. Observational on this layer; their state
        # drives /healthz and the degraded-mode interlocks.
        self.read_breaker = read_breaker
        self.write_breaker = write_breaker
        self._telemetry = telemetry if telemetry is not None else active_telemetry()
        # pod-lifecycle tracker: bind/evict POSTs carry the pod's
        # traceparent and the watch apply confirms placements
        self._lifecycle = getattr(self._telemetry, "lifecycle", None)
        self._m_flush_seconds = None
        self._m_status_retries = None
        self._m_batch_failures = None
        self._m_pipeline_stalls = None
        self._m_pipeline_indeterminate = None
        self._m_pipeline_inflight = None
        self._m_list_decode_seconds = None
        self._m_watch_batch_pods = None
        self._m_watch_coalesced = None
        if self._telemetry is not None:
            reg = self._telemetry.registry
            self._m_flush_seconds = reg.histogram(
                "crane_kube_flush_seconds",
                "Write-through pool batch flush latency", ("kind",),
            )
            self._m_status_retries = reg.counter(
                "crane_kube_status_retries_total",
                "Pooled-writer retries on retryable HTTP statuses",
            )
            # the reference's family name (its native engine and its
            # pipelined twin both count here)
            self._m_batch_failures = reg.counter(
                "crane_kube_native_flush_failures_total",
                "Bulk-flush request failures", ("status",),
            )
            self._m_pipeline_stalls = reg.counter(
                "crane_kube_pipeline_stalls_total",
                "Full-depth response waits in the pipelined write path",
            )
            self._m_pipeline_indeterminate = reg.counter(
                "crane_kube_pipeline_indeterminate_total",
                "Pipelined non-idempotent requests whose outcome a "
                "transport failure made unknowable (never re-POSTed)",
            )
            self._m_pipeline_inflight = reg.gauge(
                "crane_kube_pipeline_inflight",
                "In-flight pipelined requests, by connection", ("conn",),
            )
            self._m_list_decode_seconds = reg.histogram(
                "crane_kube_list_decode_seconds",
                "Columnar LIST page decode latency", ("kind",),
            )
            self._m_watch_batch_pods = reg.histogram(
                "crane_kube_watch_apply_batch_pods",
                "Pod watch events applied per coalesced mirror transaction",
            )
            self._m_watch_coalesced = reg.counter(
                "crane_kube_watch_coalesced_total",
                "Watch apply batches that coalesced more than one "
                "buffered event into a single mirror transaction",
                ("kind",),
            )
        u = urlsplit(self.base_url)
        self._scheme = u.scheme
        self._host = u.hostname or "127.0.0.1"
        self._port = u.port
        self._token = token
        self._context = context
        self._timeout = timeout
        # failed bulk-flush requests by status (0 = transport)
        self._batch_status_failures: dict[int, int] = {}
        self._batch_lock = threading.Lock()
        self._mirror = ClusterState()
        from ..topology.types import InMemoryNRTLister

        # NodeResourceTopology CRD mirror (ref: initTopologyInformer,
        # plugin.go:60-71); stays empty when the CRD isn't installed
        self.nrt_lister = InMemoryNRTLister()
        self._nrt_available = False
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        # open watch streams, shut under their readers by stop()
        self._streams: list[_WatchStream] = []
        self._streams_lock = threading.Lock()
        self.watch_errors = 0
        self.relists = 0  # full LISTs triggered by watch (re)connects
        # read-path counters (cheap attributes, observable without
        # telemetry)
        self.watch_applied = 0  # non-bookmark events applied
        self.watch_batches = 0  # mirror transactions those rode in
        self.watch_coalesced = 0  # batches carrying >1 event
        # the idle watch read timeout (tests shrink it to exercise idle
        # expiry)
        self._watch_timeout = WATCH_TIMEOUT_SECONDS
        # last relist's decoded node columns: (pages, node version,
        # merged columns, name -> row) — consumable by the store's
        # columnar refresh while the mirror's nodes still equal them
        self._node_columns_cache = None
        self._columns_lock = threading.Lock()
        # reflector state: last-seen resourceVersion per resource (set by
        # lists, advanced by watch deliveries incl. bookmarks); None =
        # must relist before watching (client-go's reflector contract)
        self._rvs: dict[str, str | None] = {}
        self._list_page_limit = int(list_page_limit)
        # bounded identity memory so an event watch replaying a backlog
        # (after a 410 relist, where no rv continuation exists) cannot
        # double-count Scheduled events; keyed on content
        self._seen_events: dict[tuple, None] = {}
        self._seen_events_cap = int(seen_events_cap)
        # rv watermark: a watch stream delivers events in resourceVersion
        # order, so any event at or below the highest rv already applied
        # is a replayed duplicate. The watermark is guarded: an rv
        # DECREASE on a live stream (outside the replay window after a
        # (re)connect or relist) disables rv dedup for good in favour of
        # the content-key map, maintained in parallel the whole time.
        self._event_rv_watermark = 0
        self._event_rv_trusted = True
        self._event_expect_replay = True  # initial list = a replay window
        self._seen_lock = threading.Lock()
        # bulk-bind echo suppression: pod_key -> node_name registered
        # BEFORE the binding POSTs go out. The apiserver echoes each
        # bound pod on the watch, often before ``bind_pods`` reaches its
        # own optimistic apply; applying the echo too would bump
        # pod_version a second time per bind. A matching echo is
        # confirmed (lifecycle) but not re-applied.
        self._expected_binds: dict = {}
        self._expected_lock = threading.Lock()
        # crash-safe placement-intent journal (resilience.recovery): when
        # attached, every bind/eviction POST journals an intent first
        self._intent_journal = None
        # write pool: --concurrent-syncs keep-alive workers, spawned on
        # first write (read-only clients never pay the threads)
        self._write_workers = max(1, int(concurrent_syncs))
        self._pool: list[_PooledWriter] = []
        self._pool_closed = False
        self._pool_lock = threading.Lock()
        # workers retired by stop(): their failure counters still
        # aggregate into write_failures_by_status
        self._retired_pool: list[_PooledWriter] = []

    # -- HTTP plumbing -----------------------------------------------------

    def _request(
        self,
        method: str,
        path: str,
        body=None,
        content_type="application/json",
        timeout: float | None = None,
    ):
        req = urllib.request.Request(
            self.base_url + path,
            method=method,
            data=None if body is None else json.dumps(body).encode(),
        )
        if body is not None:
            req.add_header("Content-Type", content_type)
        if self._token:
            req.add_header("Authorization", f"Bearer {self._token}")
        return urllib.request.urlopen(  # noqa: S310 — caller controls base_url
            req,
            timeout=self._timeout if timeout is None else timeout,
            context=self._context,
        )

    def _get_json(self, path: str) -> dict:
        with self._request("GET", path) as resp:
            return json.loads(resp.read())

    def _get_bytes(self, path: str) -> bytes:
        with self._request("GET", path) as resp:
            return resp.read()

    def _submit_write(
        self,
        key: str,
        method: str,
        path: str,
        body,
        content_type: str = "application/json",
        headers: dict | None = None,
    ) -> Future:
        """Route a write to the pool worker owning ``key``: all writes for
        one object land on one worker's FIFO queue, so per-object
        ordering holds however many caller threads write; distinct
        objects spread across the pool."""
        fut: Future = Future()
        # selection AND enqueue under the pool lock: a concurrent stop()
        # must not swap the pool out between them (an enqueue after the
        # shutdown sentinel would never resolve its Future)
        with self._pool_lock:
            if self._pool_closed:
                fut.set_result(WriteResult(False, 0, "client stopped"))
                return fut
            if not self._pool:
                workers = []
                for _ in range(self._write_workers):
                    w = _PooledWriter(
                        self.base_url, self._token, self._context,
                        self._timeout, retry_counter=self._m_status_retries,
                    )
                    w.start()
                    workers.append(w)
                self._pool = workers
            worker = self._pool[hash(key) % len(self._pool)]
            if self.write_breaker is not None:
                fut.add_done_callback(self._record_write_outcome)
            worker.queue.put((method, path, body, content_type, headers, fut))
        return fut

    def _record_write_outcome(self, fut: Future) -> None:
        """Feed the kube-write breaker one outcome per pooled write."""
        try:
            result = fut.result()
        except Exception:
            self.write_breaker.record_failure()
            return
        if getattr(result, "ok", bool(result)):
            self.write_breaker.record_success()
        else:
            self.write_breaker.record_failure()

    def _write(
        self,
        key: str,
        method: str,
        path: str,
        body,
        content_type: str = "application/json",
        headers: dict | None = None,
    ) -> WriteResult:
        return self._submit_write(key, method, path, body, content_type, headers).result()

    # -- lifecycle ---------------------------------------------------------

    def _list_all(self, path: str) -> tuple[list[dict], str | None]:
        """Paginated LIST (``limit``/``continue``): every item plus the
        list's resourceVersion, one bounded page per response."""
        items: list[dict] = []
        sep = "&" if "?" in path else "?"
        token = None
        rv = None
        breaker = self.read_breaker
        try:
            while True:
                url = f"{path}{sep}limit={self._list_page_limit}"
                if token:
                    url += f"&continue={token}"
                payload = self._get_json(url)
                items.extend(payload.get("items", []))
                meta = payload.get("metadata", {})
                rv = meta.get("resourceVersion", rv)
                token = meta.get("continue")
                if not token:
                    break
        except Exception:
            if breaker is not None:
                breaker.record_failure()
            raise
        if breaker is not None:
            breaker.record_success()
        return items, rv

    @staticmethod
    def _peek_continue(body: bytes):
        """The ``continue`` token from a page's head, if trivially
        extractable (the list metadata precedes ``items`` on every real
        apiserver). Best-effort: None just means the prefetch waits for
        the decode; a hit is verified against the decoded page."""
        import re

        head = body[: body.find(b'"items"') if b'"items"' in body[:4096] else 4096]
        m = re.search(rb'"continue"\s*:\s*"([^"\\]+)"', head)
        return m.group(1).decode("latin-1") if m else None

    def _list_pages(self, path: str, kind: int):
        """Paginated LIST decoded straight to columns (``decode_list_page``).
        The NEXT page prefetches on a helper thread while the current one
        decodes (its continue token rides the page head). Returns the
        decoded pages plus the list's resourceVersion."""
        from concurrent.futures import ThreadPoolExecutor

        from ..native.listdecode import decode_list_page

        pages = []
        sep = "&" if "?" in path else "?"
        rv = None
        m = self._m_list_decode_seconds
        kind_label = "nodes" if kind == 0 else "pods"

        def page_url(tok):
            url = f"{path}{sep}limit={self._list_page_limit}"
            if tok:
                url += f"&continue={tok}"
            return url

        pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="list-prefetch")
        breaker = self.read_breaker
        try:
            body = self._get_bytes(page_url(None))
            while True:
                peeked = self._peek_continue(body)
                fut = pool.submit(self._get_bytes, page_url(peeked)) if peeked else None
                t0 = time.perf_counter()
                page = decode_list_page(body, kind)
                if m is not None:
                    m.labels(kind=kind_label).observe(time.perf_counter() - t0)
                pages.append(page)
                if page.rv is not None:
                    rv = page.rv
                token = page.cont
                if not token:
                    if fut is not None:
                        fut.cancel()
                    if breaker is not None:
                        breaker.record_success()
                    return pages, rv
                if fut is not None and peeked == token:
                    body = fut.result()
                else:
                    if fut is not None:
                        fut.cancel()
                    body = self._get_bytes(page_url(token))
        except Exception:
            if breaker is not None:
                breaker.record_failure()
            raise
        finally:
            pool.shutdown(wait=True)

    def _relist_nodes(self) -> None:
        """Resync nodes into the mirror (informer relist): adds/updates
        everything listed and prunes what disappeared, as ONE mirror
        transaction (``replace_nodes``). Only the node watch thread calls
        this while its stream is down (and ``start``). The decoded
        annotation columns stay cached for the batch scheduler's
        columnar refresh (``node_annotation_columns``)."""
        self.relists += 1
        pages, rv = self._list_pages("/api/v1/nodes", 0)
        nodes = [n for page in pages for n in page.materialize()]
        with self._columns_lock:
            self._mirror.replace_nodes(nodes)
            # keyed on node_version (NOT sched_version): pod and event
            # churn must not invalidate node columns that didn't change
            self._node_columns_cache = (pages, self._mirror.node_version, None, None)
        self._rvs["nodes"] = rv

    def node_annotation_columns(self):
        """The last relist's decoded annotation columns — ``(version,
        names, keys, values, offsets)`` with row ``i`` owning
        ``keys[offsets[i]:offsets[i+1]]`` — equal to the mirror's node
        annotations at ``version``. When annotation writes moved the
        mirror since (watch deliveries or patches), the columns are
        patched from the dirty-name journal and re-keyed to the current
        version; None when the journal no longer covers the interval or
        the node set changed (callers fall back to ``list_nodes``)."""
        with self._columns_lock:
            cache = self._node_columns_cache
            if cache is None:
                return None
            pages, version, merged, pos = cache
            if merged is None:
                merged = self._merge_page_columns(pages)
                pages = None  # the merged columns supersede the pages
            if version != self._mirror.node_version:
                moved = self._mirror.node_annotations_since(version)
                if moved is None:
                    self._node_columns_cache = None
                    return None
                version, changed = moved
                if changed:
                    if pos is None:
                        pos = {name: i for i, name in enumerate(merged[0])}
                    merged = _patch_columns(merged, pos, changed)
            self._node_columns_cache = (pages, version, merged, pos)
            return (version,) + merged

    @staticmethod
    def _merge_page_columns(pages):
        names: list[str] = []
        keys: list = []
        values: list = []
        offset_parts = [np.zeros(1, dtype=np.int64)]
        total = 0
        for page in pages:
            pn, pk, pv, po = page.node_annotation_columns()
            names.extend(pn)
            keys.extend(pk)
            values.extend(pv)
            offset_parts.append(po[1:] + total)
            total += int(po[-1]) if len(po) > 1 else 0
        return names, keys, values, np.concatenate(offset_parts)

    def _relist_pods(self) -> None:
        """Pod twin of ``_relist_nodes`` (called only by the pod watch
        thread while its own stream is down, and by ``start``)."""
        self.relists += 1
        pages, rv = self._list_pages("/api/v1/pods", 1)
        pods = [p for page in pages for p in page.materialize()]
        self._mirror.replace_pods(pods)
        self._rvs["pods"] = rv

    def _relist_events(self) -> None:
        """Event twin: the reference's event informer also list+watches
        (factory.go:25-33), so Scheduled events emitted while the watch
        was down are recovered by a list. Entries are sorted by rv before
        ingestion: the dedup watermark assumes monotonic delivery."""
        self.relists += 1
        raw, rv = self._list_all(
            "/api/v1/events?fieldSelector=reason%3DScheduled%2Ctype%3DNormal"
        )

        def rv_of(obj) -> int:
            try:
                return int(obj.get("metadata", {}).get("resourceVersion", 0))
            except (TypeError, ValueError):
                return 0

        self._mark_event_stream_restart()  # the list IS a replay
        for obj in sorted(raw, key=rv_of):
            self._apply_event("ADDED", obj)
        self._rvs["events"] = rv

    def _relist_nrt(self) -> None:
        """NRT CRD twin of ``_relist_nodes`` (NRT watch thread only)."""
        self.relists += 1
        raw, rv = self._list_all(NRT_API_PATH)
        items = [nrt_from_json(i) for i in raw]
        for nrt in items:
            self.nrt_lister.upsert(nrt)
        live = {nrt.name for nrt in items}
        for name in [n for n in self.nrt_lister.names() if n not in live]:
            self.nrt_lister.delete(name)
        self._rvs["nrts"] = rv

    def start(self) -> None:
        """Initial list of nodes + pods (+ NRT CRs when the CRD is
        installed), then a watch thread per resource plus Scheduled
        events (server-side filtered; its list+watch recovers events
        missed while disconnected)."""
        self._relist_nodes()
        self._relist_pods()
        watches = [
            ("/api/v1/nodes?watch=1", self._apply_node_batch,
             self._relist_nodes, "nodes"),
            ("/api/v1/pods?watch=1", self._apply_pod_batch,
             self._relist_pods, "pods"),
            ("/api/v1/events?watch=1&fieldSelector="
             "reason%3DScheduled%2Ctype%3DNormal",
             self._apply_event_batch, self._relist_events, "events"),
        ]
        crd_absent = False
        try:
            self._relist_nrt()
            self._nrt_available = True
        except urllib.error.HTTPError as e:
            if e.code == 404:
                # CRD not installed (normal for Dynamic-only clusters):
                # a prober re-checks, so a CRD applied later is still
                # mirrored without a restart
                crd_absent = True
            else:
                self.watch_errors += 1  # transient 5xx / RBAC gap
        except (urllib.error.URLError, OSError):
            self.watch_errors += 1  # network blip: the watch loop retries
        if crd_absent:
            prober = threading.Thread(target=self._nrt_prober, daemon=True)
        else:
            watches.append((f"{NRT_API_PATH}?watch=1", self._apply_nrt_batch,
                            self._relist_nrt, "nrts"))
            prober = None
        for path, apply, relist, rv_key in watches:
            wt = threading.Thread(target=self._watch_loop,
                                  args=(path, apply, relist, rv_key), daemon=True)
            wt.start()
            self._threads.append(wt)
        if prober is not None:
            prober.start()
            self._threads.append(prober)

    def _nrt_prober(self) -> None:
        """Waits for the NRT CRD to appear (installed after this process
        started), then becomes the NRT watch thread."""
        while not self._stop.wait(timeout=NRT_RETRY_SECONDS):
            try:
                self._relist_nrt()
            except urllib.error.HTTPError as e:
                if e.code != 404:
                    self.watch_errors += 1
                continue
            except (urllib.error.URLError, OSError):
                self.watch_errors += 1
                continue
            self._nrt_available = True
            self._watch_loop(f"{NRT_API_PATH}?watch=1", self._apply_nrt_batch,
                             self._relist_nrt, "nrts")
            return

    def stop(self) -> None:
        """Stop every thread this client started and wait for it: the
        watch threads (their streams are closed under them, so a blocked
        read returns at once), the NRT prober and the write workers
        (queued writes drain first, FIFO)."""
        self._stop.set()
        with self._streams_lock:
            streams = list(self._streams)
        for stream in streams:
            stream.shutdown()
        with self._pool_lock:
            self._pool_closed = True
            pool, self._pool = self._pool, []
            self._retired_pool.extend(pool)
        for w in pool:
            w.queue.put(None)
        deadline = time.monotonic() + _STOP_JOIN_SECONDS
        for t in self._threads + pool:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        self._threads = [t for t in self._threads if t.is_alive()]

    # -- Python pipelined multi-connection flush ---------------------------

    def _render_request(self, method: str, path: str, body,
                        content_type: str = "application/json",
                        extra_headers: dict | None = None) -> bytes:
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
        host = f"{self._host}:{self._port}" if self._port else self._host
        auth = f"Authorization: Bearer {self._token}\r\n" if self._token else ""
        extra = ""
        if extra_headers:
            extra = "".join(f"{k}: {v}\r\n" for k, v in extra_headers.items())
        return (
            f"{method} {path} HTTP/1.1\r\nHost: {host}\r\n"
            f"Content-Length: {len(data)}\r\n"
            f"Content-Type: {content_type}\r\n{auth}{extra}\r\n"
        ).encode("latin-1") + data

    @staticmethod
    def _json_name(name: str) -> str:
        """K8s object names are DNS labels, so embedding them in a JSON
        template without escaping is exact; anything else falls back to
        the real encoder."""
        if '"' in name or "\\" in name or any(ord(c) < 0x20 for c in name):
            return json.dumps(name)[1:-1]
        return name

    def _render_binding_body(self, namespace: str, name: str, node_name: str) -> bytes:
        """The binding subresource body from a literal template (byte-
        compatible JSON; at bind-burst rates ``json.dumps`` per pod is a
        measurable share of the host core)."""
        return (
            '{"metadata": {"name": "%s", "namespace": "%s"}, '
            '"target": {"kind": "Node", "name": "%s"}}'
            % (self._json_name(name), self._json_name(namespace),
               self._json_name(node_name))
        ).encode()

    def _connect_raw(self) -> _RawHTTPConnection:
        if self._scheme == "https":
            context = self._context
            if context is None:
                context = ssl.create_default_context()
            return _RawHTTPConnection(self._host, self._port, self._timeout, context=context)
        return _RawHTTPConnection(self._host, self._port, self._timeout)

    def _pipelined_flush(self, rendered: list[bytes], idempotent: bool) -> list[int]:
        """Pipelined fan-out: the batch stripes across up to
        ``concurrent_syncs`` keep-alive connections, each connection keeps
        up to ``_PIPELINE_DEPTH`` requests in flight, and responses are
        accounted strictly in request order.

        POST-safety contract: a response-phase transport failure marks the
        awaited request and everything already sent behind it on that
        connection INDETERMINATE — non-idempotent requests (binds) are
        never re-POSTed (status 0); idempotent merge-patches retry once on
        a fresh connection. A send-phase failure only ever reroutes
        requests the server cannot have parsed completely (each request is
        its own ``sendall``). Returns per-request statuses (0 = transport
        failure / indeterminate); status-based retry stays with the
        caller."""
        n = len(rendered)
        statuses = [0] * n
        conns = max(1, min(self._write_workers, n))
        bounds = [n * w // conns for w in range(conns + 1)]
        stall_total = [0] * conns
        indet_total = [0] * conns
        threads = []
        for w in range(conns):
            t = threading.Thread(
                target=self._pipelined_conn_worker,
                args=(w, rendered, range(bounds[w], bounds[w + 1]),
                      statuses, idempotent, stall_total, indet_total),
                daemon=True,
            )
            t.start()
            threads.append(t)
        for t in threads:
            t.join()
        if self._m_pipeline_stalls is not None:
            stalls = sum(stall_total)
            if stalls:
                self._m_pipeline_stalls.inc(stalls)
            indet = sum(indet_total)
            if indet:
                self._m_pipeline_indeterminate.inc(indet)
        return statuses

    def _pipelined_conn_worker(self, conn_id: int, rendered, indices,
                               statuses, idempotent: bool,
                               stall_total, indet_total) -> None:
        import http.client
        from collections import deque

        gauge = None
        if self._m_pipeline_inflight is not None:
            gauge = self._m_pipeline_inflight.labels(conn=str(conn_id))
        depth = _PIPELINE_DEPTH
        local: deque = deque()  # (idx, attempt) retries, served first
        todo = iter(indices)
        inflight: deque = deque()
        conn = None

        def claim():
            if local:
                return local.popleft()
            nxt = next(todo, None)
            return None if nxt is None else (nxt, 0)

        def drop_conn():
            nonlocal conn
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass
                conn = None

        def fail_inflight():
            # transport failure: everything in flight is indeterminate
            while inflight:
                idx, attempt = inflight.popleft()
                if idempotent and attempt < 1:
                    local.append((idx, attempt + 1))
                else:
                    statuses[idx] = 0
                    if not idempotent:
                        indet_total[conn_id] += 1

        try:
            while True:
                # fill phase: pipeline up to depth requests
                batch = []
                while len(inflight) + len(batch) < depth:
                    item = claim()
                    if item is None:
                        break
                    batch.append(item)
                if batch and conn is None:
                    try:
                        conn = self._connect_raw()
                    except OSError:
                        for idx, _ in batch:
                            statuses[idx] = 0
                        if not inflight and not local:
                            return
                        continue
                send_failed = False
                for item in batch:
                    try:
                        conn.send_raw(rendered[item[0]])
                    except (OSError, http.client.HTTPException):
                        # the failed request was at most partially
                        # written (its own sendall): the server cannot
                        # have parsed it, so it reroutes like everything
                        # after it that was never sent
                        drop_conn()
                        for b in [item] + batch[batch.index(item) + 1:]:
                            if b[1] < 1:
                                local.append((b[0], b[1] + 1))
                            else:
                                statuses[b[0]] = 0
                        fail_inflight()
                        send_failed = True
                        break
                    inflight.append(item)
                if send_failed:
                    continue
                if not inflight:
                    if not local:
                        return
                    continue
                if gauge is not None:
                    gauge.set(len(inflight))
                # drain phase: responses strictly in request order
                if len(inflight) >= depth:
                    stall_total[conn_id] += 1
                while inflight:
                    try:
                        resp = conn.getresponse()
                    except (OSError, http.client.HTTPException):
                        drop_conn()
                        fail_inflight()
                        break
                    idx, _ = inflight.popleft()
                    statuses[idx] = resp.status
                    if resp.will_close:
                        # the server ends the connection: responses
                        # behind this one will never arrive
                        drop_conn()
                        fail_inflight()
                        break
                if gauge is not None:
                    gauge.set(0)
        finally:
            drop_conn()

    def _count_batch_failure(self, status: int) -> None:
        with self._batch_lock:
            self._batch_status_failures[status] = (
                self._batch_status_failures.get(status, 0) + 1)
        if self._m_batch_failures is not None:
            self._m_batch_failures.labels(status=str(status)).inc()

    @property
    def write_failures_by_status(self) -> dict[int, int]:
        """Failed-write counts by HTTP status across the pool and the
        bulk flushes (0 = transport-level failure): a 409 bind conflict is
        countable apart from a 5xx or a dead connection."""
        with self._pool_lock:
            workers = list(self._pool) + list(self._retired_pool)
        out: dict[int, int] = {}
        for w in workers:
            # one C-level copy: the worker may insert a first-seen status
            for status, n in dict(w.status_failures).items():
                out[status] = out.get(status, 0) + n
        with self._batch_lock:
            for status, n in self._batch_status_failures.items():
                out[status] = out.get(status, 0) + n
        return out

    def pending_writes(self) -> int:
        """Writes enqueued on the pooled workers but not yet sent: the
        bind-plane depth signal for overload backpressure."""
        with self._pool_lock:
            workers = list(self._pool)
        return sum(w.queue.qsize() for w in workers)

    # -- watch -------------------------------------------------------------

    @staticmethod
    def _reconnect_immediately(delivered: bool, failures: int,
                               lived: float, idle_expired: bool) -> bool:
        """Zero-delay reconnect policy: a healthy long-lived stream
        (delivered something, bookmarks included, and stayed up a
        while) or one that expired idle reconnects at once; short-lived
        streams back off exponentially even when they delivered (a
        server answering each watch with one bookmark then EOF must not
        drive a hot loop), as does anything that failed."""
        return failures == 0 and (idle_expired or (delivered and lived >= 1.0))

    def _drain_lines(self, stream: _WatchStream, tail: bytes):
        """Read everything the stream already has — one blocking
        ``read_some``, then keep pulling while the stream holds undrained
        raw bytes or a zero-timeout ``select`` says more are on the wire
        — and split out the complete lines. A line torn across chunks
        stays in ``tail`` until its terminator arrives. Returns
        (complete_lines, tail, eof)."""
        import select

        chunk = stream.read_some()
        if not chunk:
            return [], tail, True
        parts = [tail, chunk]  # joined once: += on bytes is quadratic
        size = len(tail) + len(chunk)
        fd = stream.fileno()
        while size < (1 << 20):  # bound one transaction
            if not stream.has_buffered():
                try:
                    if not select.select([fd], [], [], 0)[0]:
                        break
                except (OSError, ValueError):
                    break
            chunk = stream.read_some()
            if not chunk:
                break  # EOF: deliver the drained lines, report it next call
            parts.append(chunk)
            size += len(chunk)
        buf = b"".join(parts)
        if b"\n" not in buf:
            return [], buf, False
        *lines, tail = buf.split(b"\n")
        return lines, tail, False

    def _open_watch_stream(self, path: str) -> _WatchStream:
        context = None
        if self._scheme == "https":
            context = self._context
            if context is None:
                context = ssl.create_default_context()
        return _WatchStream(self._host, self._port, path, self._watch_timeout,
                            token=self._token, context=context)

    def _consume_watch(self, url: str, apply_batch, rv_key: str):
        """Coalesced stream consumption: each wakeup drains every line the
        socket already buffered and applies them as one mirror
        transaction, in delivery order. rv bookkeeping advances after the
        batch lands, exactly as far as the batch did; an ERROR event
        splits the batch (everything before it applies first). Returns
        (delivered, failed, stopped)."""
        delivered = False
        failed = False
        stream = self._open_watch_stream(url)
        with self._streams_lock:
            self._streams.append(stream)
        try:
            tail = b""
            while True:
                if self._stop.is_set():
                    return delivered, failed, True
                lines, tail, eof = self._drain_lines(stream, tail)
                if eof:
                    if self._stop.is_set():
                        return delivered, failed, True
                    if tail.strip():
                        # connection cut mid-line: the JSONDecodeError a
                        # per-line reader hits on a torn final line
                        json.loads(tail)
                    return delivered, failed, False
                batch, last_rv, error_obj, n_seen = self._parse_watch_lines(lines)
                if n_seen:
                    delivered = True
                if batch:
                    apply_batch(batch)
                    self.watch_batches += 1
                    self.watch_applied += len(batch)
                    if len(batch) > 1:
                        self.watch_coalesced += 1
                        if self._m_watch_coalesced is not None:
                            self._m_watch_coalesced.labels(kind=rv_key).inc()
                if last_rv is not None:
                    self._rvs[rv_key] = last_rv
                if error_obj is not None:
                    if error_obj.get("code") == 410:
                        self._rvs[rv_key] = None  # resume window expired
                    else:
                        self.watch_errors += 1
                        failed = True
                    return delivered, failed, False
        finally:
            with self._streams_lock:
                if stream in self._streams:
                    self._streams.remove(stream)
            stream.close()

    def _watch_loop(self, path: str, apply_batch: Callable[[list], None],
                    relist: Callable[[], None] | None, rv_key: str) -> None:
        """Reflector semantics (client-go's contract, which the reference
        inherits from its informers, factory.go:16-33): list once, then
        watch from the list's resourceVersion with bookmarks; reconnects
        resume from the last delivered rv (no relist); only a 410 Gone
        (resume point expired server-side) forces one relist."""
        failures = 0
        breaker = self.read_breaker
        while not self._stop.is_set():
            delivered = False
            idle_expired = False
            failures_before = failures
            connected_at = time.monotonic()
            try:
                if relist is not None and self._rvs.get(rv_key) is None:
                    # first connect or post-410: one full list
                    # establishes the resume point
                    relist()
                rv = self._rvs.get(rv_key)
                url = path + "&allowWatchBookmarks=true"
                if rv is not None:
                    url += f"&resourceVersion={rv}"
                delivered, failed, stopped = self._consume_watch(url, apply_batch, rv_key)
                if stopped:
                    return
                if delivered:
                    # reset only on DELIVERED events: a flapping apiserver
                    # that accepts watches then fails the stream must
                    # still escalate the backoff
                    failures = 0
                if failed:
                    failures += 1
            except TimeoutError:
                # normal idle-watch expiry on a quiet cluster: not a
                # failure; reconnect immediately
                idle_expired = True
            except urllib.error.HTTPError as e:
                if e.code == 410:
                    self._rvs[rv_key] = None  # relist on reconnect
                else:
                    self.watch_errors += 1
                    failures += 1
            except (urllib.error.URLError, OSError, json.JSONDecodeError):
                if self._stop.is_set():
                    return
                self.watch_errors += 1
                failures += 1
            if breaker is not None:
                # one breaker outcome per stream iteration
                if failures > failures_before:
                    breaker.record_failure()
                elif delivered or idle_expired:
                    breaker.record_success()
            lived = time.monotonic() - connected_at
            if self._reconnect_immediately(delivered, failures, lived, idle_expired):
                continue
            if self._stop.wait(timeout=min(30.0, 1.0 * (2 ** min(failures, 5)))):
                return

    @staticmethod
    def _parse_watch_lines(lines: list):
        """Parse one drained batch of watch lines, one ``json.loads`` per
        line. Returns ``(batch, last_rv, error_obj, n_seen)`` with raw
        ``(change_type, object)`` dicts for the kind's batch applier."""
        batch = []
        last_rv = None
        error_obj = None
        n_seen = 0
        for line in lines:
            line = line.strip()
            if not line:
                continue
            n_seen += 1
            change = json.loads(line)
            change_type = change.get("type", "")
            obj = change.get("object", {})
            if change_type == "ERROR":
                error_obj = obj
                break
            if change_type != "BOOKMARK":
                batch.append((change_type, obj))
            obj_rv = obj.get("metadata", {}).get("resourceVersion")
            if obj_rv is not None:
                last_rv = obj_rv
        return batch, last_rv, error_obj, n_seen

    def _apply_node_batch(self, changes: list) -> None:
        """Coalesced node watch apply: the whole drained batch decodes
        first, then lands as ONE mirror transaction."""
        self._mirror.apply_node_changes([(t, node_from_json(o)) for t, o in changes])

    def _confirm_placements(self, decoded: list) -> None:
        """Watch-confirmed hook: a non-DELETED pod event carrying a
        nodeName is the authoritative end of a placement (the lifecycle's
        ``watch_confirm`` stage and the intent journal's tombstone); a
        DELETED event tombstones any open eviction intent. Untracked keys
        cost one dict miss inside one lock."""
        lc = self._lifecycle
        journal = self._intent_journal
        if lc is None and journal is None:
            return
        placed = [(pod.key(), pod.node_name) for t, pod in decoded
                  if t != "DELETED" and pod.node_name]
        if lc is not None and placed:
            lc.confirmed_batch(placed)
        if journal is not None:
            if placed:
                journal.tombstone_batch(placed)
            for t, pod in decoded:
                if t == "DELETED":
                    journal.tombstone_deleted(pod.key())

    def _drop_expected_echoes(self, decoded: list) -> list:
        """Filter watch pod changes that echo an in-flight ``bind_pods``
        batch (same pod, same node as the registered expectation): the
        optimistic mirror apply IS that change. Callers confirm the
        lifecycle BEFORE filtering."""
        if not self._expected_binds:
            return decoded
        with self._expected_lock:
            expected = dict(self._expected_binds)
        return [
            (t, pod) for t, pod in decoded
            if t == "DELETED" or not pod.node_name
            or expected.get(pod.key()) != pod.node_name
        ]

    def _apply_pod_batch(self, changes: list) -> None:
        if self._m_watch_batch_pods is not None:
            self._m_watch_batch_pods.observe(len(changes))
        decoded = [(t, pod_from_json(o)) for t, o in changes]
        self._confirm_placements(decoded)
        decoded = self._drop_expected_echoes(decoded)
        if decoded:
            self._mirror.apply_pod_changes(decoded)

    def _apply_nrt_batch(self, changes: list) -> None:
        for change_type, obj in changes:
            nrt = nrt_from_json(obj)
            if change_type == "DELETED":
                self.nrt_lister.delete(nrt.name)
            else:
                self.nrt_lister.upsert(nrt)

    def _mark_event_stream_restart(self) -> None:
        """A new events stream (watch (re)connect or relist) may replay a
        prefix of already-applied history: rvs at or below the watermark
        inside this window are replays, not violations."""
        with self._seen_lock:
            self._event_expect_replay = True

    def _apply_event(self, change_type: str, obj: dict) -> None:
        event = self._dedup_event(change_type, obj)
        if event is not None:
            self._mirror.emit_event(event)

    def _apply_event_batch(self, changes: list) -> None:
        """Coalesced event apply: dedup each drained event in order (the
        rv watermark advances exactly as the per-event path would), then
        deliver the survivors as ONE batched emit."""
        deliver = []
        for change_type, obj in changes:
            event = self._dedup_event(change_type, obj)
            if event is not None:
                deliver.append(event)
        if deliver:
            self._mirror.emit_events(deliver)

    def _dedup_event(self, change_type: str, obj: dict):
        """Decode + dedup one watch event; returns the Event to deliver or
        None (duplicate, replayed or DELETED). Primary dedup is the
        apiserver resourceVersion watermark (streams deliver in rv order,
        so rv <= watermark is a replay); the content-key map runs in
        parallel as the dedup for rv-less or non-integer-rv servers and
        the fallback once the monotonicity guard trips."""
        if change_type == "DELETED":
            return None
        event = event_from_json(obj)
        server_rv = obj.get("metadata", {}).get("resourceVersion")
        rv_int = None
        if server_rv is not None:
            try:
                rv_int = int(server_rv)
            except (TypeError, ValueError):
                rv_int = None
        key = (event.namespace, event.name, event.count, event.last_timestamp,
               event.event_time, event.message)
        deliver = False
        with self._seen_lock:
            if rv_int is not None and self._event_rv_trusted:
                if rv_int <= self._event_rv_watermark:
                    if self._event_expect_replay:
                        return None  # replayed prefix after a (re)connect
                    # rv went BACKWARD on a live stream: never trust rvs
                    # again; this event falls through to content dedup
                    self._event_rv_trusted = False
                else:
                    self._event_rv_watermark = rv_int
                    self._event_expect_replay = False
                    self._record_seen_locked(key)
                    # a fresh rv wins even on a content collision:
                    # identical payloads do recur
                    deliver = True
            if not deliver:
                if key in self._seen_events:
                    return None
                self._record_seen_locked(key)
        return event

    def _record_seen_locked(self, key: tuple) -> None:
        if key in self._seen_events:
            return
        if len(self._seen_events) >= self._seen_events_cap:
            self._seen_events.pop(next(iter(self._seen_events)))
        self._seen_events[key] = None

    # -- reads: the informer mirror ----------------------------------------

    @property
    def sched_version(self) -> int:
        return self._mirror.sched_version

    @property
    def node_set_version(self) -> int:
        return self._mirror.node_set_version

    @property
    def node_version(self) -> int:
        return self._mirror.node_version

    @property
    def pod_version(self) -> int:
        return self._mirror.pod_version

    def pod_changes_since(self, version: int):
        return self._mirror.pod_changes_since(version)

    def configure_shards(self, count: int, overlap: float = 0.0, layout=None) -> None:
        self._mirror.configure_shards(count, overlap, layout=layout)

    def shard_layout(self):
        return self._mirror.shard_layout()

    def shard_keyspace(self):
        return self._mirror.shard_keyspace()

    def reshard(self, target):
        return self._mirror.reshard(target)

    def shard_versions(self, index: int) -> tuple[int, int, int]:
        return self._mirror.shard_versions(index)

    def dirty_nodes_since(self, version: int, shard: int | None = None):
        return self._mirror.dirty_nodes_since(version, shard)

    def dirty_journal_stats(self) -> dict:
        return self._mirror.dirty_journal_stats()

    def has_node(self, name: str) -> bool:
        return self._mirror.has_node(name)

    def list_nodes(self):
        return self._mirror.list_nodes()

    def count_pods_all(self) -> dict[str, int]:
        return self._mirror.count_pods_all()

    def get_node(self, name: str):
        return self._mirror.get_node(name)

    def node_names(self):
        return self._mirror.node_names()

    def list_pods(self, node_name: str | None = None):
        return self._mirror.list_pods(node_name)

    def count_pods(self, node_name: str) -> int:
        return self._mirror.count_pods(node_name)

    def get_pod(self, key: str):
        return self._mirror.get_pod(key)

    def get_pod_live(self, key: str):
        """GET the pod from the apiserver, bypassing the mirror (the
        restart reconciler's read: a just-restarted mirror is cold).
        404 -> None; transport errors raise."""
        namespace, name = key.split("/", 1)
        try:
            obj = self._get_json(f"/api/v1/namespaces/{namespace}/pods/{name}")
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise
        return pod_from_json(obj)

    def attach_intent_journal(self, journal) -> None:
        """Install the crash-safety journal (``resilience.recovery.
        IntentJournal``). From here on every bind/eviction POST is
        journaled intent-before-wire; watch confirmations tombstone."""
        self._intent_journal = journal

    def list_events(self):
        return self._mirror.list_events()

    def get_event(self, key: str):
        return self._mirror.get_event(key)

    def subscribe_events(self, handler) -> None:
        self._mirror.subscribe_events(handler)

    def subscribe_events_batch(self, handler) -> None:
        self._mirror.subscribe_events_batch(handler)

    # -- writes: through the API -------------------------------------------
    #
    # Writes never raise: ClusterState's contract is a bool, and the
    # annotator's worker/ticker threads rely on skip-and-retry. HTTP
    # errors, refused connections and timeouts all report False.

    def patch_node_annotation(self, name: str, key: str, value: str) -> bool:
        """Annotation merge-patch (ref: node.go:123-146)."""
        body = {"metadata": {"annotations": {key: value}}}
        if not self._write(name, "PATCH", f"/api/v1/nodes/{name}", body,
                           "application/merge-patch+json"):
            return False
        # optimistic local apply: the writer's next read sees its write.
        # The API write succeeded, so report True even if the object has
        # not reached the mirror yet (watch lag)
        self._mirror.patch_node_annotation(name, key, value)
        return True

    def patch_node_annotations_bulk(self, per_node) -> int:
        """Batch annotation patch: ONE merge-patch per node carrying the
        whole sweep's keys. Batches of 64 or more ride the pipelined
        multi-connection flush (transient failures re-driven through the
        pool, which owns backoff and Retry-After); smaller ones are all
        submitted to the pool up front and gathered after. Returns the
        patched count."""
        m = self._m_flush_seconds
        if m is None:
            return self._patch_node_annotations_bulk_impl(per_node)
        t0 = time.perf_counter()
        try:
            return self._patch_node_annotations_bulk_impl(per_node)
        finally:
            m.labels(kind="annotations").observe(time.perf_counter() - t0)

    def _render_annotation_patch(self, name: str, kv) -> bytes:
        return self._render_request(
            "PATCH", f"/api/v1/nodes/{name}",
            {"metadata": {"annotations": dict(kv)}}, "application/merge-patch+json",
        )

    def _patch_node_annotations_bulk_impl(self, per_node) -> int:
        items = list(per_node.items())
        patched = 0
        if len(items) >= _PIPELINE_FLUSH_MIN:
            reqs = [self._render_annotation_patch(n, kv) for n, kv in items]
            statuses = self._pipelined_flush(reqs, idempotent=True)
            retry_items = []
            ok_updates: dict[str, dict] = {}
            for (name, kv), status in zip(items, statuses):
                if 200 <= status < 300:
                    ok_updates[name] = kv
                elif status == 0 or status in _RETRYABLE_ANY \
                        or status in _RETRYABLE_IDEMPOTENT:
                    # transport loss / transient status: re-drive through
                    # the pool, which owns backoff + Retry-After
                    if status:
                        self._count_batch_failure(int(status))
                    retry_items.append((name, kv))
                else:
                    # durable failure (404/422/...): count once and drop
                    self._count_batch_failure(int(status))
            if ok_updates:
                self._mirror.patch_node_annotations_bulk(ok_updates)
                patched += len(ok_updates)
            items = retry_items
        futs = []
        for name, kv in items:
            body = {"metadata": {"annotations": dict(kv)}}
            futs.append((name, kv, self._submit_write(
                name, "PATCH", f"/api/v1/nodes/{name}", body,
                "application/merge-patch+json")))
        for name, kv, fut in futs:
            if fut.result():
                self._mirror.patch_node_annotations_bulk({name: kv})
                patched += 1
        return patched

    def patch_node_annotations_columns(self, names, columns) -> int:
        """Columnar flush entry (``ClusterState``'s contract): HTTP
        merge-patches are per node, so the aligned columns pivot into
        per-node dicts and ride the bulk primitive."""
        return self.patch_node_annotation_groups([(names, columns)])

    def patch_node_annotation_groups(self, groups) -> int:
        """Pivot ALL column groups into per-node dicts and issue ONE
        merge-patch per node (applying them group by group would
        multiply the patch count per node by the group count)."""
        per_node: dict[str, dict[str, str]] = {}
        for names, columns in groups:
            for key, values in columns.items():
                for name, value in zip(names, values):
                    d = per_node.get(name)
                    if d is None:
                        d = per_node[name] = {}
                    d[key] = value
        return self.patch_node_annotations_bulk(per_node)

    def patch_pod_annotation(self, key: str, anno_key: str, value: str) -> bool:
        """PreBind's pod-annotation patch (ref: binder.go:19-65)."""
        namespace, name = key.split("/", 1)
        body = {"metadata": {"annotations": {anno_key: value}}}
        if not self._write(key, "PATCH", f"/api/v1/namespaces/{namespace}/pods/{name}",
                           body, "application/merge-patch+json"):
            return False
        # the mirror apply is best-effort (watch lag)
        self._mirror.patch_pod_annotation(key, anno_key, value)
        return True

    def evict_pod(self, key: str, now: float | None = None) -> bool:
        """POST the eviction subresource (the descheduler's write).
        Evictions are NOT idempotent, so the request rides the pooled
        writer's POST discipline: a response-phase transport loss is
        indeterminate and never blindly re-POSTed (only 429 re-drives)."""
        namespace, name = key.split("/", 1)
        body = {
            "apiVersion": "policy/v1",
            "kind": "Eviction",
            "metadata": {"name": name, "namespace": namespace},
        }
        headers = self._trace_header(key)
        pod = self._mirror.get_pod(key)
        iid = self._journal_single(
            "evict", key, pod.node_name if pod is not None else None, headers)
        res = self._write(key, "POST",
                          f"/api/v1/namespaces/{namespace}/pods/{name}/eviction",
                          body, headers=headers)
        self._journal_single_outcome(iid, res)
        if not res:
            return False
        # optimistic mirror apply; the watch's DELETED event confirms
        self._mirror.delete_pod(key)
        return True

    def add_pod(self, pod: Pod) -> None:
        """Create the pod via the API. The body carries the FULL pod
        (containers and resources, ownerReferences, nodeName): any later
        watch delivery rebuilds the mirror entry from the server's copy."""
        def containers(items):
            return [
                {"name": c.name,
                 "resources": {"requests": dict(c.resources.requests),
                               "limits": dict(c.resources.limits)}}
                for c in items
            ]

        body = {
            "metadata": {
                "name": pod.name,
                "namespace": pod.namespace,
                "annotations": dict(pod.annotations),
                "ownerReferences": [{"kind": r.kind, "name": r.name}
                                    for r in pod.owner_references],
            },
            "spec": {
                "nodeName": pod.node_name,
                "containers": containers(pod.containers),
                "initContainers": containers(pod.init_containers),
                "overhead": dict(pod.overhead),
            },
        }
        if not self._write(pod.key(), "POST",
                           f"/api/v1/namespaces/{pod.namespace}/pods", body):
            # never raise (ClusterState.add_pod cannot fail): the pod is
            # simply not created
            self.watch_errors += 1
            return
        self._mirror.add_pod(pod)

    def add_pods(self, pods) -> None:
        """Bulk twin of ``add_pod``. A pod whose creation POST fails is
        absent, so its later binding POST fails too."""
        for pod in pods:
            self.add_pod(pod)

    def _post_batch(self, items: list) -> list[bool]:
        """THE non-idempotent POST batch: ``items`` are (key, path, body).
        Batches of 64 or more ride the pipelined flush; 429s (explicitly
        not processed, so safe to re-POST) re-drive through the pool,
        which honours Retry-After; any other failure is durable. Returns
        per-item success."""
        m = self._m_flush_seconds
        if m is None:
            return self._post_batch_impl(items)
        t0 = time.perf_counter()
        try:
            return self._post_batch_impl(items)
        finally:
            m.labels(kind="post_batch").observe(time.perf_counter() - t0)

    def _trace_header(self, key: str) -> dict | None:
        """``{"traceparent": ...}`` when the pod is lifecycle-tracked,
        plus the ``crane-deadline-ms`` budget."""
        lc = self._lifecycle
        tp = lc.traceparent(key) if lc is not None else None
        headers = {"traceparent": tp} if tp else None
        dl = _deadline_pair()
        if dl is not None:
            headers = headers or {}
            headers[dl[0]] = dl[1]
        return headers

    @staticmethod
    def _intent_op(path: str) -> str | None:
        """Which journal op a POST path is; None for creations (a
        duplicate create is a 409, not a double bind)."""
        if path.endswith("/binding"):
            return "bind"
        if path.endswith("/eviction"):
            return "evict"
        return None

    def _journal_intents(self, items, tp) -> list:
        """One intent line per bind/eviction item, all under one fresh
        window id, before any wire traffic. Returns per-item intent ids
        (None for items that are not journaled)."""
        journal = self._intent_journal
        window = journal.begin_window()
        ids: list = [None] * len(items)
        for i, (key, path, body) in enumerate(items):
            op = self._intent_op(path)
            if op is None:
                continue
            if op == "bind":
                # bodies arrive pre-rendered (the binding template)
                doc = json.loads(body) if isinstance(body, (bytes, str)) else body
                node = doc.get("target", {}).get("name")
            else:
                pod = self._mirror.get_pod(key)
                node = pod.node_name if pod is not None else None
            ids[i] = journal.intent(op, key, node, trace=tp.get(key), window=window)
        return ids

    def _journal_outcomes(self, intent_ids, ok, final_status) -> None:
        """Resolve each journaled intent: 2xx -> ack (applied), a real
        server status -> nack (answered, not applied: re-drivable), 0 ->
        unresolved (transport loss or pipelined indeterminate; only
        restart reconciliation may decide it)."""
        journal = self._intent_journal
        for iid, good, status in zip(intent_ids, ok, final_status):
            if iid is None:
                continue
            if good:
                journal.ack(iid)
            elif status > 0:
                journal.nack(iid, status)
            else:
                journal.unresolved(iid)

    def _journal_single(self, op: str, key: str, node, headers):
        """Intent line for a single-POST path (bind_pod / evict_pod)."""
        journal = self._intent_journal
        if journal is None:
            return None
        trace = headers.get("traceparent") if headers else None
        return journal.intent(op, key, node, trace=trace)

    def _journal_single_outcome(self, intent_id, result) -> None:
        if intent_id is None:
            return
        self._journal_outcomes([intent_id], [bool(result)],
                               [int(getattr(result, "status", 0) or 0)])

    def _post_batch_impl(self, items: list) -> list[bool]:
        n = len(items)
        ok = [False] * n
        retry: list[int] = []
        lc = self._lifecycle
        # one lock for the whole batch; only tracked pods get headers
        tp = lc.traceparent_batch([key for key, _, _ in items]) if lc is not None else {}
        dl = _deadline_pair()

        def _hdr(key):
            v = tp.get(key)
            headers = {"traceparent": v} if v else None
            if dl is not None:
                headers = headers or {}
                headers[dl[0]] = dl[1]
            return headers

        # crash safety: journal every bind/eviction intent before any
        # byte is on the wire (a kill after this leaves a replayable
        # record; a kill before it leaves nothing in flight); final_status
        # resolves each intent after the batch
        intent_ids = (self._journal_intents(items, tp)
                      if self._intent_journal is not None else None)
        final_status = [0] * n  # 0 = indeterminate unless a route reports
        if n >= _PIPELINE_FLUSH_MIN:
            reqs = [self._render_request("POST", path, body, extra_headers=_hdr(key))
                    for key, path, body in items]
            for i, status in enumerate(self._pipelined_flush(reqs, idempotent=False)):
                final_status[i] = int(status)
                if 200 <= status < 300:
                    ok[i] = True
                else:
                    # status 0 covers transport loss AND the pipelined
                    # indeterminate set: never re-driven (the server may
                    # have processed them; the watch delivers the outcome)
                    self._count_batch_failure(int(status))
                    if status in _RETRYABLE_ANY:
                        retry.append(i)
        else:
            retry = list(range(n))
        if retry:
            futs = [(i, self._submit_write(items[i][0], "POST", items[i][1],
                                           items[i][2], headers=_hdr(items[i][0])))
                    for i in retry]
            for i, fut in futs:
                res = fut.result()
                ok[i] = bool(res)
                final_status[i] = int(getattr(res, "status", 0) or 0)
        if intent_ids is not None:
            self._journal_outcomes(intent_ids, ok, final_status)
        if lc is not None and tp:
            posted = [(items[i][0], None) for i in range(n)
                      if ok[i] and items[i][0] in tp and items[i][1].endswith("/binding")]
            if posted:
                lc.posted_batch(posted)
        return ok

    # -- columnar bursts through the API -----------------------------------

    def add_pod_burst(self, namespace: str, names: list):
        """Columnar burst arrival through the API: one creation POST per
        pod, the mirror keeping the burst as rows. The mirror burst
        registers BEFORE the POSTs go out, so watch echoes of the created
        pods shadow existing rows (``_add_pod_locked``) instead of racing
        ahead into duplicate object+row entries. Rows whose POST failed
        are retired at once and marked dead in the handle, so
        ``bind_burst`` never binds a pod the server refused."""
        path = f"/api/v1/namespaces/{namespace}/pods"
        burst = self._mirror.add_pod_burst(namespace, names)
        ok = self._post_batch([
            (f"{namespace}/{name}", path,
             {"metadata": {"name": name, "namespace": namespace}, "spec": {}})
            for name in names
        ])
        failed = {row for row, good in enumerate(ok) if not good}
        if failed:
            self._mirror.retire_burst_rows(burst, sorted(failed))
        return _KubeBurstHandle(burst, failed)

    def _burst_bind_items(self, handle, node_table, node_idx):
        """Shared front half of ``bind_burst``/``bind_bursts``: the
        bindable rows and their rendered POST items."""
        burst = handle.burst
        node_idx = np.asarray(node_idx, dtype=np.int32)
        rows = [row for row in range(len(node_idx))
                if node_idx[row] >= 0 and row not in handle.failed]
        ns = burst.namespace
        names = burst.names
        items = []
        for row in rows:
            name = names[row]
            items.append((
                f"{ns}/{name}",
                f"/api/v1/namespaces/{ns}/pods/{name}/binding",
                self._render_binding_body(ns, name, node_table[int(node_idx[row])]),
            ))
        return node_idx, rows, items

    def _burst_bind_apply(self, handle, node_table, node_idx, rows, ok, now) -> list[int]:
        """Shared back half: optimistic mirror apply for the rows the
        server accepted, no local events. Rows still in burst form take
        the columnar apply; rows a watch echo already shadowed into
        object pods take one batched object-path apply."""
        burst = handle.burst
        ns = burst.namespace
        names = burst.names
        ok_rows = sorted(row for row, good in zip(rows, ok) if good)
        if not ok_rows:
            return []
        mirror_idx = np.full((len(node_idx),), -1, dtype=np.int32)
        mirror_idx[ok_rows] = node_idx[ok_rows]
        columnar_bound = {int(r) for r in self._mirror.bind_burst(
            burst, node_table, mirror_idx, now, notify=False)}
        echoed = [(f"{ns}/{names[row]}", node_table[int(node_idx[row])])
                  for row in ok_rows if row not in columnar_bound]
        if echoed:
            self._mirror.bind_pods(echoed, now, notify=False)
        # the SERVER's acceptance defines what bound
        return ok_rows

    def bind_burst(self, handle, node_table, node_idx, now=None) -> list[int]:
        """Columnar bind through the binding subresource: one POST per
        bound row, the mirror applying placements for the rows the
        server accepted without local events (the apiserver's Scheduled
        events arrive through the watch). Returns bound rows."""
        node_idx, rows, items = self._burst_bind_items(handle, node_table, node_idx)
        if not rows:
            return []
        ok = self._post_batch(items)
        return self._burst_bind_apply(handle, node_table, node_idx, rows, ok, now)

    def bind_bursts(self, bursts, now=None) -> list[list[int]]:
        """Coalesced multi-burst bind: the binding POSTs of every
        ``(handle, node_table, node_idx)`` triple ride ONE shared batch,
        then each burst's mirror apply runs as usual. Returns one
        bound-rows list per burst, in input order."""
        prepped = []
        all_items: list = []
        for handle, node_table, node_idx in bursts:
            node_idx, rows, items = self._burst_bind_items(handle, node_table, node_idx)
            prepped.append((handle, node_table, node_idx, rows, len(all_items), len(items)))
            all_items.extend(items)
        ok = self._post_batch(all_items) if all_items else []
        out = []
        for handle, node_table, node_idx, rows, off, cnt in prepped:
            if not rows:
                out.append([])
                continue
            out.append(self._burst_bind_apply(handle, node_table, node_idx, rows,
                                              ok[off:off + cnt], now))
        return out

    @staticmethod
    def _binding_request(pod_key: str, node_name: str) -> tuple[str, dict]:
        namespace, name = pod_key.split("/", 1)
        return (
            f"/api/v1/namespaces/{namespace}/pods/{name}/binding",
            {"metadata": {"name": name, "namespace": namespace},
             "target": {"kind": "Node", "name": node_name}},
        )

    def bind_pod(self, pod_key: str, node_name: str, now: float | None = None) -> bool:
        """POST the ``binding`` subresource: the scheduler's bind call.
        The apiserver emits the Scheduled event; it reaches subscribers
        through the event watch."""
        path, body = self._binding_request(pod_key, node_name)
        headers = self._trace_header(pod_key)
        iid = self._journal_single("bind", pod_key, node_name, headers)
        res = self._write(pod_key, "POST", path, body, headers=headers)
        self._journal_single_outcome(iid, res)
        if not res:
            return False
        if self._lifecycle is not None:
            self._lifecycle.posted(pod_key, node=node_name)
        # optimistic placement apply (no event here: the apiserver's
        # arrives through the watch)
        pod = self._mirror.get_pod(pod_key)
        if pod is not None:
            from dataclasses import replace

            self._mirror.add_pod(replace(pod, node_name=node_name))
        return True

    def bind_pods(self, assignments, now: float | None = None) -> list[str]:
        """Bind a batch through the binding subresource (``_post_batch``),
        gathered in input order so the returned bound-key list is
        deterministic; the optimistic mirror apply for the accepted subset
        is ONE batched placement transaction without local events."""
        pairs = list(assignments.items() if hasattr(assignments, "items") else assignments)
        items = []
        for pod_key, node_name in pairs:
            namespace, name = pod_key.split("/", 1)
            items.append((pod_key, f"/api/v1/namespaces/{namespace}/pods/{name}/binding",
                          self._render_binding_body(namespace, name, node_name)))
        # register expectations BEFORE the POSTs: the echo of each bound
        # pod must not count as a second pod change
        with self._expected_lock:
            self._expected_binds.update(pairs)
        try:
            ok = self._post_batch(items)
            bound = []
            bound_pairs = []
            for (pod_key, node_name), good in zip(pairs, ok):
                if good:
                    bound.append(pod_key)
                    bound_pairs.append((pod_key, node_name))
            if bound_pairs:
                self._mirror.bind_pods(bound_pairs, now, notify=False)
        finally:
            with self._expected_lock:
                for pod_key, _node in pairs:
                    self._expected_binds.pop(pod_key, None)
        return bound
