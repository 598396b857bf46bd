"""Node annotator: the metric-sync engine.

Copy of ``crane_scheduler_tpu/annotator/controller.py``. It reaches the
port's host library (``native/``) on the reference's two paths: the C++
binding heap (``NativeBindingRecords``, ``AnnotatorConfig.
use_native_bindings``, on by default as in the reference) and
``bulk_parse_values`` for a direct-mode sweep's value column.
``use_native_bindings=False`` selects the pure-Python ``BindingRecords``.
Both heaps give the same counts, and the native parse gives the per-string
Go ``ParseFloat`` (``go_parse_float``) bit for bit.

Reproduces the reference controller (ref: pkg/controller/annotator): per
sync-policy tickers fan out ``node/metric`` work items; workers query the
metrics source (node IP first, node name fallback), patch the node
annotation ``metric -> "value,localtime"``, and re-patch ``node_hot_value``
with every item; failures re-queue with 10s→360s exponential backoff.

Two operating modes:

- **threaded** (``start``/``stop``): live tickers + worker threads, the
  production shape (worker count = ``concurrent_syncs``,
  ref: controller.go:61-85);
- **synchronous** (``sync_all_once``): one deterministic full pass with an
  injected ``now``, used by tests and the simulator.

The columnar twist: annotations remain the durable contract (the cluster
is the source of truth, SURVEY §5), but scorer reads go through the bulk
``refresh_store`` path that re-ingests all annotations into the columnar
``NodeLoadStore`` in one sweep instead of per-node string parsing in the
scheduling hot path.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from ..cluster.state import ClusterState, Node
from ..constants import (
    DEFAULT_BINDING_HEAP_SIZE,
    DEFAULT_CONCURRENT_SYNCS,
    NODE_HOT_VALUE_KEY,
)
from ..loadstore.codec import (
    decode_annotation_or_missing,
    encode_annotation,
)
from ..native.codec import bulk_parse_values
from ..utils.logging import vlog
from ..utils.timeutil import format_local_time
from ..loadstore.store import NodeLoadStore
from ..metrics.source import (
    MetricsQueryError,
    MetricsSource,
    MetricsTransportError,
)
from ..policy.types import DynamicSchedulerPolicy
from ..telemetry import Telemetry, active as active_telemetry
from ..telemetry import tracing
from .bindings import BindingRecords, max_hot_value_time_range
from .events import EventIngestor
from .workqueue import RateLimitedQueue


@dataclass
class AnnotatorConfig:
    """ref: pkg/controller/annotator/config/types.go:4-14."""

    binding_heap_size: int = DEFAULT_BINDING_HEAP_SIZE
    concurrent_syncs: int = DEFAULT_CONCURRENT_SYNCS
    # The C++ binding heap (one-pass batch counts); False selects the
    # pure-Python heap. A library that fails to build raises.
    use_native_bindings: bool = True
    # Tickers call sync_metric_bulk (one metrics query per metric per
    # tick) instead of fanning out per-node work items; nodes missing
    # from the bulk result still take the per-node queue path.
    bulk_sync: bool = False
    # With an attached store (attach_store), bulk syncs write the metric
    # column straight into it (bulk_set_by_name) and emit the annotation
    # patches asynchronously — the annotation stays the durable contract,
    # but a scheduler sharing the store never re-parses strings.
    direct_store: bool = False


def _split_meta_key(key: str) -> tuple[str, str]:
    """ref: pkg/controller/annotator/utils.go:11-19."""
    parts = key.split("/")
    if len(parts) != 2:
        raise ValueError(f"unexpected key format: {key!r}")
    return parts[0], parts[1]


def _meta_key(node_name: str, metric_name: str) -> str:
    return f"{node_name}/{metric_name}"


def _index_samples_by_host(samples: dict) -> dict:
    """Index metric samples by exact instance AND by host with the port
    stripped (the reference matches ``instance=~"IP"`` then
    ``instance=~"IP:.+"``, prometheus.go:50-67). Built only when some
    instance actually carries a port; a bare-IP sample set (the common
    case) is returned as-is, skipping a full-dict rebuild."""
    if not any(":" in k for k in samples):
        return samples
    by_host: dict[str, str] = {}
    for instance, value in samples.items():
        by_host.setdefault(instance, value)
        host = instance.rsplit(":", 1)[0]
        if host != instance:
            by_host.setdefault(host, value)
    return by_host


class NodeAnnotator:
    def __init__(
        self,
        cluster: ClusterState,
        metrics: MetricsSource,
        policy: DynamicSchedulerPolicy,
        config: AnnotatorConfig | None = None,
        telemetry: Telemetry | None = None,
        leader_check=None,
        health=None,
    ):
        self.cluster = cluster
        self.metrics = metrics
        self.policy = policy
        self.config = config or AnnotatorConfig()
        # ``leader_check()`` is consulted immediately before any
        # annotation write dispatch — a lease stolen between queue pop
        # and patch flush must abort the flush (a non-leader writing
        # annotations races the new leader's sweeps). None = always lead.
        self.leader_check = leader_check
        # HealthRegistry: bulk-sweep outages flip the ``prometheus``
        # component here (the breaker transition hook covers CLIs; this
        # covers embedded annotators wired with just the registry)
        self.health = health
        self._telemetry = (
            telemetry if telemetry is not None else active_telemetry()
        )
        self._m_sync_seconds = self._m_flush_seconds = None
        self._m_queue_depth = self._m_backoff = self._m_errors = None
        self._m_leader_aborts = None
        if self._telemetry is not None:
            reg = self._telemetry.registry
            self._m_sync_seconds = reg.histogram(
                "crane_annotator_sync_seconds",
                "Bulk metric sweep duration", ("metric",),
            )
            self._m_flush_seconds = reg.histogram(
                "crane_annotator_patch_flush_seconds",
                "Deferred annotation-patch flush latency",
            )
            self._m_queue_depth = reg.gauge(
                "crane_annotator_workqueue_depth",
                "Per-node work items queued or in backoff",
            )
            self._m_backoff = reg.counter(
                "crane_annotator_backoff_retries_total",
                "Sync items re-queued with exponential backoff",
            )
            self._m_errors = reg.counter(
                "crane_annotator_sync_errors_total",
                "Failed node/metric sync attempts",
            )
            self._m_leader_aborts = reg.counter(
                "crane_annotator_leader_aborts_total",
                "Annotation writes dropped because leadership was lost "
                "between sweep and flush",
            )
        records = BindingRecords
        if self.config.use_native_bindings:
            from ..native.bindings import NativeBindingRecords as records
        self.binding_records = records(
            self.config.binding_heap_size,
            max_hot_value_time_range(policy.spec.hot_value),
        )
        self.event_ingestor = EventIngestor(cluster, self.binding_records)
        # ((now, heap version), hot values of every node with bindings)
        self._hot_memo: tuple | None = None
        self.queue = RateLimitedQueue()
        self.synced = 0
        self.sync_errors = 0
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        # direct-store mode (AnnotatorConfig.direct_store)
        self._store: NodeLoadStore | None = None
        # columnar pending: (key, names, values) segments appended by
        # bulk sweeps — no per-entry dict churn on the sync path, and
        # flush applies whole columns through the cluster's columnar
        # primitive (the dict pivot dominated 50k flush profiles). The
        # ONLY deferred-annotation buffer: the queue path patches the
        # cluster directly (annotate_node_load), it never defers.
        self._anno_cols: list[tuple[str, list[str], list[str]]] = []
        self._anno_lock = threading.Lock()
        # (node_set_version, [(name, ip)], [name], [ip]) — a bulk sweep
        # re-reads the same tables |metrics| times per cycle (_node_tables)
        self._node_pairs_cache: tuple | None = None
        self._last_prune_state: tuple | None = None

    def attach_store(self, store: NodeLoadStore) -> NodeLoadStore:
        """Register the store that direct-mode bulk syncs write into."""
        self._store = store
        return store

    def _emit_annotation_column(self, key: str, names, values) -> None:
        """One appended segment per (key, sweep): ownership of ``values``
        transfers to the flusher (callers pass freshly-built lists);
        ``names`` is treated as immutable (it is the sweep's shared node
        table in the common case, and segment grouping at flush time
        keys on its identity)."""
        with self._anno_lock:
            self._anno_cols.append((key, names, values))

    def _node_tables(self):
        """``(pairs, names, ips)`` for the sweep loops, cached on the
        cluster's node-set version (annotation patches don't change
        names/addresses)."""
        version = getattr(self.cluster, "node_set_version", None)
        cache = self._node_pairs_cache
        if version is None or cache is None or cache[0] != version:
            pairs = [(n.name, n.internal_ip()) for n in self.cluster.list_nodes()]
            cache = (
                version, pairs, [p[0] for p in pairs], [p[1] for p in pairs],
            )
            if version is not None:
                self._node_pairs_cache = cache
        return cache[1], cache[2], cache[3]

    def _node_pairs(self) -> list[tuple[str, str]]:
        """(name, internal_ip) per node (see ``_node_tables``)."""
        return self._node_tables()[0]

    def _leading(self) -> bool:
        """False only when a leader_check is wired AND reports lost."""
        check = self.leader_check
        if check is None:
            return True
        try:
            return bool(check())
        except Exception:
            return False  # can't prove leadership: don't write

    def _abort_not_leader(self) -> None:
        if self._m_leader_aborts is not None:
            self._m_leader_aborts.inc()
        vlog(1, "annotation write aborted: leadership lost")

    def _patch_per_node(self, per_node: dict) -> None:
        """Apply assembled ``{node: {key: raw}}`` patches through the
        cluster's per-node bulk primitive when present (one lock/HTTP
        PATCH per node), else per-(node, key). The ONE write-dispatch
        implementation for flush/sweep/backfill."""
        if not self._leading():
            self._abort_not_leader()
            return
        bulk = getattr(self.cluster, "patch_node_annotations_bulk", None)
        if bulk is not None:
            bulk(per_node)
            return
        patch = self.cluster.patch_node_annotation
        for node_name, kv in per_node.items():
            for key, raw in kv.items():
                patch(node_name, key, raw)

    def flush_annotations(self) -> int:
        """Apply deferred annotation patches (direct mode writes the store
        first; the annotation contract catches up here — from the emitter
        thread in threaded mode, or explicitly in synchronous tests).
        Uses the cluster's bulk patch primitive when present (one
        lock/PATCH per node instead of per (node, key))."""
        m = self._m_flush_seconds
        if m is None:
            return self._flush_annotations_impl()
        t0 = time.perf_counter()
        total = self._flush_annotations_impl()
        if total:  # idle emitter ticks must not pollute the latency hist
            m.observe(time.perf_counter() - t0)
            vlog(1, f"annotation flush: {total} keys, "
                    f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        return total

    def _flush_annotations_impl(self) -> int:
        with self._anno_lock:
            cols, self._anno_cols = self._anno_cols, []
        if not cols:
            return 0
        if not self._leading():
            # lease stolen between sweep (queue pop) and flush: the
            # drained columns are DROPPED, not re-queued — the new
            # leader's own sweeps are the source of truth now
            self._abort_not_leader()
            return 0
        total = 0
        # group column segments by the identity of their names list (the
        # sweep's shared node table): one columnar patch per distinct
        # row set, duplicate keys within a group collapse last-wins
        # (exactly the semantics the per-node dict merge had). Groups
        # apply in first-emission order, so a later sweep's segment
        # always lands after an earlier sweep's.
        groups: dict[int, tuple[list[str], dict[str, list[str]]]] = {}
        for key, names, values in cols:
            g = groups.get(id(names))
            if g is None:
                g = groups[id(names)] = (names, {})
            g[1][key] = values
        group_list = list(groups.values())
        for names, keyvals in group_list:
            total += sum(len(v) for v in keyvals.values())
        # one call for ALL groups: a sweep with fallback-filtered node
        # sets produces one group per metric, and a per-group apply
        # would cost the kube path one HTTP PATCH per (node, group) —
        # the groups API lets it pivot everything into one patch per
        # node (kube.py), while the in-memory cluster applies segments
        groups_api = getattr(
            self.cluster, "patch_node_annotation_groups", None
        )
        if groups_api is not None:
            groups_api(group_list)
            return total
        columns_api = getattr(
            self.cluster, "patch_node_annotations_columns", None
        )
        if columns_api is not None:
            for names, keyvals in group_list:
                columns_api(names, keyvals)
            return total
        # write-through fallback: pivot across ALL groups so each node
        # still gets exactly one patch
        per_node: dict[str, dict[str, str]] = {}
        for names, keyvals in group_list:
            for key, values in keyvals.items():
                for name, raw in zip(names, values):
                    d = per_node.get(name)
                    if d is None:
                        d = per_node[name] = {}
                    d[key] = raw
        self._patch_per_node(per_node)
        return total

    # -- core sync logic ---------------------------------------------------

    def sync_node(self, key: str, now: float | None = None) -> bool:
        """Process one ``node/metric`` item; True = success ("forget")
        (ref: node.go:72-99)."""
        if now is None:
            now = time.time()
        try:
            node_name, metric_name = _split_meta_key(key)
        except ValueError:
            return True  # invalid key: drop, don't retry
        node = self.cluster.get_node(node_name)
        if node is None:
            return True  # node gone: drop
        try:
            tel = self._telemetry
            if tel is not None:
                # same anno_ts join key as the bulk sweep: the wire
                # truncates the timestamp, so lifecycle records match
                # only the truncated value
                _, anno_ts = decode_annotation_or_missing(
                    f"0,{format_local_time(now)}"
                )
                ctx = tracing.current() or tracing.new_context()
                with tracing.use(ctx):
                    with tel.spans.span(
                        "annotator_sync",
                        metric=metric_name,
                        node=node_name,
                        anno_ts=anno_ts,
                    ):
                        self.annotate_node_load(node, metric_name, now)
                        self.annotate_node_hot_value(node, now)
            else:
                self.annotate_node_load(node, metric_name, now)
                self.annotate_node_hot_value(node, now)
        except MetricsQueryError:
            self.sync_errors += 1
            if self._m_errors is not None:
                self._m_errors.inc()
            return False
        self.synced += 1
        return True

    def annotate_node_load(self, node: Node, metric_name: str, now: float) -> str:
        """Query by IP, fall back to name, patch annotation; returns the
        encoded annotation (ref: node.go:101-111)."""
        value = None
        try:
            value = self.metrics.query_by_node_ip(metric_name, node.internal_ip())
        except MetricsQueryError:
            value = None
        if not value:
            value = self.metrics.query_by_node_name(metric_name, node.name)
        if not value:
            raise MetricsQueryError(f"failed to get data {metric_name} for {node.name}")
        anno = encode_annotation(value, now)
        self.cluster.patch_node_annotation(node.name, metric_name, anno)
        if self._store is not None and self.config.direct_store:
            # Direct mode pairs with a scheduler that never re-reads
            # cluster annotations (refresh_from_cluster=False), so the
            # queue path must land in the store too or fallback nodes'
            # rows stay NaN forever. Targeted write of just this metric —
            # a full re-ingest of the cluster map would wipe store values
            # whose deferred annotation patches haven't flushed yet.
            # Re-check liveness AFTER the (blocking) metrics query: a node
            # deleted mid-query must not have its pruned row resurrected.
            # The residual race window is lock-free microseconds, and any
            # loser row is re-pruned on the next bulk tick.
            if self.cluster.get_node(node.name) is not None:
                v, ts = decode_annotation_or_missing(anno)
                self._store.set_metric(node.name, metric_name, v, ts)
        return anno

    def hot_value(self, node_name: str, now: float) -> int:
        """hotValue = Σ_p count(node, window_p) // count_p — integer
        division per policy entry (ref: node.go:113-121).

        A per-node sweep asks this of every node at one ``now``. The
        reference rescans the heap per (node, window); here one
        ``hot_values_batch`` pass per (``now``, heap version) answers
        them all, with the same values."""
        key = (now, self.binding_records.version)
        memo = self._hot_memo
        if memo is None or memo[0] != key:
            memo = (key, self.hot_values_batch(now))
            self._hot_memo = memo
        return memo[1].get(node_name, 0)

    def hot_values_batch(self, now: float) -> dict[str, int]:
        """Hot values for every node with bindings, in ONE heap pass.

        Same per-entry integer division as ``hot_value`` (ref:
        node.go:113-121), but the windowed counts come from the backend's
        ``counts_batch`` (one O(|heap|·|windows|) sweep) instead of a
        per-(node, window) heap rescan. Nodes absent from the result have
        hot value 0.
        """
        policies = self.policy.spec.hot_value
        if not policies:
            return {}
        for p in policies:
            if p.count == 0:
                # match the per-node path (and Go's integer divide panic,
                # ref: node.go:117) instead of numpy's silent 0
                raise ZeroDivisionError("hotValue policy count is 0")
        import numpy as np

        names, counts = self.binding_records.counts_batch(
            [p.time_range_seconds for p in policies], now
        )
        if not names:
            return {}
        divisors = np.asarray([p.count for p in policies], dtype=np.int64)
        hot = (counts // divisors[:, None]).sum(axis=0)
        return dict(zip(names, (int(v) for v in hot)))

    def annotate_node_hot_value(self, node: Node, now: float) -> str:
        value = self.hot_value(node.name, now)
        anno = encode_annotation(str(value), now)
        self.cluster.patch_node_annotation(node.name, NODE_HOT_VALUE_KEY, anno)
        if self._store is not None and self.config.direct_store:
            v, ts = decode_annotation_or_missing(anno)
            # Same liveness-checked row resolution as set_metric above: a
            # new node whose hot-value sync lands before any metric write
            # must still get a store row, or its hot value stays stale
            # until the next bulk tick despite the annotation patch.
            self._store.set_hot_value(
                node.name, v, ts,
                create=self.cluster.get_node(node.name) is not None,
            )
        return anno

    def enqueue_metric(self, metric_name: str) -> None:
        """One tick: fan out a work item per node
        (ref: node.go:148-161)."""
        for node_name in self.cluster.node_names():
            self.queue.add(_meta_key(node_name, metric_name))

    def sync_all_once(self, now: float | None = None) -> None:
        """Deterministic full pass over nodes × syncPolicy (test/sim path)."""
        if now is None:
            now = time.time()
        for sp in self.policy.spec.sync_period:
            for node_name in self.cluster.node_names():
                self.sync_node(_meta_key(node_name, sp.name), now)

    _HOT_UNSET = object()  # sentinel: compute hot values in this call

    def sync_metric_bulk(
        self,
        metric_name: str,
        now: float | None = None,
        hot_by_node=_HOT_UNSET,
        hot_emitted: set | None = None,
    ) -> int:
        """Bulk sync: ONE metrics query covers every node.

        The reference issues |nodes| filtered Prometheus queries per
        metric per cycle (ref: node.go:148-177); sources exposing
        ``query_all_by_metric`` serve the whole column in one instant
        query. Nodes without a sample fall back to the per-node work
        queue (IP-then-name path with backoff). Returns patched count.

        ``hot_by_node``: pass ``hot_values_batch(now)``'s result when
        sweeping several metrics at one ``now`` (hot values are a pure
        function of the heap and ``now`` — recomputing the heap sweep per
        metric is pure overhead); default computes it here.

        ``hot_emitted``: each independent metric tick re-patches the hot
        value like the reference (ref: node.go:101-121). Within one
        same-``now`` multi-metric sweep all those re-patches are
        identical, so ``sync_all_once_bulk`` shares one set here and each
        node's hot value is written exactly once — by whichever metric
        pass sees it first (a node missing from one metric's samples
        still gets its hot value from a later pass). Default None writes
        hot for every node, the standalone per-tick behavior.
        """
        tel = self._telemetry
        if tel is None:
            return self._sync_metric_bulk_impl(
                metric_name, now, hot_by_node, hot_emitted
            )
        if now is None:
            now = time.time()
        # the sweep stamps ONE wire-truncated timestamp on every row it
        # patches (see _sync_metric_bulk_impl); carrying that exact value
        # on the span is the join key between a placement's lifecycle
        # record (rec["anno_ts"]) and the annotator sync that fed it
        _, anno_ts = decode_annotation_or_missing(f"0,{format_local_time(now)}")
        ctx = tracing.current() or tracing.new_context()
        t0 = time.perf_counter()
        with tracing.use(ctx):
            with tel.spans.span(
                "annotator_sync", metric=metric_name, anno_ts=anno_ts
            ):
                patched = self._sync_metric_bulk_impl(
                    metric_name, now, hot_by_node, hot_emitted
                )
        self._m_sync_seconds.labels(metric=metric_name).observe(
            time.perf_counter() - t0
        )
        self._m_queue_depth.set(len(self.queue))
        return patched

    def _sync_metric_bulk_impl(
        self, metric_name, now, hot_by_node, hot_emitted
    ) -> int:
        if now is None:
            now = time.time()
        self._prune_direct_store()
        query_all = getattr(self.metrics, "query_all_by_metric", None)
        if query_all is None:
            # source has no bulk support: per-node path for everyone
            self.enqueue_metric(metric_name)
            return 0
        try:
            samples = query_all(metric_name)
        except MetricsTransportError as e:
            # the source itself is down (not "no data"): fanning out a
            # work item per node would just hammer a dead endpoint —
            # count the error, flip health, and let the breaker's
            # half-open probe decide when the next sweep goes through
            self.sync_errors += 1
            if self._m_errors is not None:
                self._m_errors.inc()
            if self.health is not None:
                self.health.set(
                    "prometheus", "degraded", f"bulk sweep failed: {e}"
                )
            return 0
        except MetricsQueryError:
            self.enqueue_metric(metric_name)
            return 0
        if self.health is not None:
            self.health.set("prometheus", "healthy")
        import numpy as np

        direct = self._store is not None and self.config.direct_store
        if hot_by_node is self._HOT_UNSET:
            hot_by_node = self.hot_values_batch(now)
        # The direct-store write must be bit-identical to a future
        # re-ingest of the emitted annotation string (the timestamp
        # truncates to seconds in the wire format). Every row in this
        # sweep shares ONE encoded timestamp, decoded once; values parse
        # per string with Go ParseFloat semantics; annotation strings
        # are one concat per node. A per-node Python loop body here
        # dominated full-loop profiles at 50k nodes.
        ts_str = format_local_time(now)
        _, shared_ts = decode_annotation_or_missing(f"0,{ts_str}")
        nan, neg_inf = float("nan"), float("-inf")
        stale = shared_ts == neg_inf
        pairs, all_names, all_ips = self._node_tables()
        # bulk column providers may return ``(hosts, values)`` aligned
        # lists (zero dict churn end to end) or the classic {ip: value}
        # mapping — when the host sequence matches the node table
        # exactly, take the values as-is and skip both the host-alias
        # scan and |nodes| dict lookups
        col_floats = None
        if isinstance(samples, tuple):
            hosts, col = samples[0], samples[1]
            if hosts == all_ips:
                vals = list(col)
                if len(samples) == 3:
                    # pre-parsed float column (contract: exactly the
                    # Go-parse of the strings, NaN where unparseable) —
                    # valid only while rows stay aligned with `names`
                    col_floats = samples[2]
            else:
                by_host_get = _index_samples_by_host(
                    dict(zip(hosts, col))
                ).get
                vals = [
                    by_host_get(ip) or by_host_get(name)
                    for name, ip in pairs
                ]
        elif list(samples) == all_ips:
            vals = list(samples.values())
        else:
            by_host_get = _index_samples_by_host(samples).get
            vals = [by_host_get(ip) or by_host_get(name) for name, ip in pairs]
        if all(vals):
            names = all_names
        else:
            queue_add = self.queue.add
            for (name, _), v in zip(pairs, vals):
                if not v:
                    queue_add(_meta_key(name, metric_name))
            names = [p[0] for p, v in zip(pairs, vals) if v]
            vals = [v for v in vals if v]
        patched = len(names)
        self.synced += patched
        if not names:
            return 0
        # hot values: once per (node, sweep) — see the docstring
        if hot_emitted is None:
            hot_names = names
        else:
            hot_names = [n for n in names if n not in hot_emitted]
            hot_emitted.update(hot_names)
            if len(hot_names) == len(names):
                # nothing filtered: share the names OBJECT so the flush
                # groups the hot column with the metric columns (one
                # columnar patch instead of two)
                hot_names = names
        hot_annos: list[str] = []
        if hot_names:
            hget = hot_by_node.get
            hots = [hget(n, 0) for n in hot_names]
            hot_annos = [f"{h},{ts_str}" for h in hots]
        suffix = "," + ts_str
        annos = [v + suffix for v in vals]
        if direct:
            self._emit_annotation_column(metric_name, names, annos)
            if hot_names:
                self._emit_annotation_column(
                    NODE_HOT_VALUE_KEY, hot_names, hot_annos
                )
            if stale:
                metric_vals = np.full((len(names),), nan)
                metric_ts = np.full((len(names),), neg_inf)
            elif col_floats is not None and names is all_names:
                # pre-parsed column, still row-aligned (no fallback
                # filtering happened): NaN marks missing/unparseable by
                # the 3-tuple contract — sources with legitimate NaN
                # samples must use the 2-tuple (string) form
                metric_vals = np.asarray(col_floats, dtype=np.float64)
                ok = ~np.isnan(metric_vals)
                metric_ts = np.where(ok, shared_ts, neg_inf)
            else:
                metric_vals, ok = bulk_parse_values(vals)
                metric_vals = np.where(ok, metric_vals, nan)
                metric_ts = np.where(ok, shared_ts, neg_inf)
            hot_vals = hot_ts_arr = None
            if hot_names:
                if stale:
                    hot_vals = np.full((len(hot_names),), nan)
                else:
                    hot_vals = np.asarray(hots, dtype=np.float64)
                hot_ts_arr = np.full((len(hot_names),), shared_ts)
            # One lock hold resolves name->row AND writes, so a
            # concurrent prune's swap-removes can't redirect stale ids.
            if hot_names is names or len(hot_names) == len(names):
                # hot rows align with metric rows (the common sweep)
                self._store.bulk_set_by_name(
                    metric_name, names, metric_vals, metric_ts,
                    hot_vals, hot_ts_arr,
                )
            else:
                self._store.bulk_set_by_name(
                    metric_name, names, metric_vals, metric_ts
                )
                if hot_names:
                    self._store.bulk_set_by_name(
                        None, hot_names, None, None, hot_vals, hot_ts_arr
                    )
        else:
            # write-through mode (e.g. --master): coalesce this tick's
            # metric + hot writes into ONE patch per node when the
            # cluster supports it — the reference pays a separate PATCH
            # round-trip per (node, metric) AND per hot re-patch
            # (ref: node.go:101-121); against a real apiserver that is
            # 2x|nodes| HTTP calls per tick collapsed to |nodes|
            per_node = {
                name: {metric_name: anno}
                for name, anno in zip(names, annos)
            }
            for name, hot_anno in zip(hot_names, hot_annos):
                per_node.setdefault(name, {})[NODE_HOT_VALUE_KEY] = hot_anno
            self._patch_per_node(per_node)
        return patched

    def _prune_direct_store(self) -> None:
        """Direct mode is the only reader path for the shared store (the
        scheduler's refresh() returns early), so every bulk tick must
        prune deleted cluster nodes or they stay schedulable — including
        ticks that fall back to the per-node queue (no bulk query support
        or a failing metrics source). Skipped while neither the cluster's
        node set nor the store's row layout has changed since the last
        prune (the prune scans |rows| names)."""
        if self._store is None or not self.config.direct_store:
            return
        state = (
            getattr(self.cluster, "node_set_version", None),
            self._store.layout_version,
        )
        if state[0] is not None and state == self._last_prune_state:
            return
        self._store.prune_absent(self.cluster.node_names())
        self._last_prune_state = (state[0], self._store.layout_version)

    def backfill_once(self, offset_seconds: float, now: float | None = None) -> int:
        """Cold-start backfill: seed MISSING metric annotations with each
        metric's value one ``offset`` ago, timestamped ``now - offset``
        so the staleness windows see exactly how old the data is.

        This wires the reference's defined-but-never-called offset query
        (ref: prometheus.go:82-98) into the one place history genuinely
        helps: a fresh cluster (or brand-new nodes) gets load-aware
        scoring immediately instead of scheduling blind until the first
        sync tick per metric lands. Existing annotations are never
        overwritten — live data always wins — and hot values are not
        backfilled (the binding heap rebuilds from the event replay).
        Returns the number of (node, metric) cells seeded. Sources
        without bulk offset support are skipped.
        """
        if now is None:
            now = time.time()
        query_all = getattr(self.metrics, "query_all_by_metric", None)
        if query_all is None:
            return 0
        offset_str = f"{int(offset_seconds)}s"
        stamp = now - offset_seconds
        ts_str = format_local_time(stamp)
        direct = self._store is not None and self.config.direct_store
        per_node: dict[str, dict[str, str]] = {}
        for sp in self.policy.spec.sync_period:
            try:
                samples = query_all(sp.name, offset=offset_str)
            except MetricsQueryError:
                continue
            except TypeError:  # source has no offset support
                return 0
            if isinstance(samples, tuple):
                # 2- or 3-tuple column form: (hosts, strings[, floats])
                samples = dict(zip(samples[0], samples[1]))
            by_host_get = _index_samples_by_host(samples).get
            for name, ip in self._node_pairs():
                node = self.cluster.get_node(name)
                if node is None or sp.name in (node.annotations or {}):
                    continue  # never overwrite live data
                value = by_host_get(ip) or by_host_get(name)
                if not value:
                    continue
                per_node.setdefault(name, {})[sp.name] = f"{value},{ts_str}"
        if not per_node:
            return 0
        # one PATCH per node (a 50k x 12 cold start must not issue 600k
        # round-trips); per-cell fallback without bulk support
        self._patch_per_node(per_node)
        if direct:
            for name, kv in per_node.items():
                for key, anno in kv.items():
                    self._store.ingest_annotation(name, key, anno)
        return sum(len(kv) for kv in per_node.values())

    def sync_all_once_bulk(self, now: float | None = None) -> None:
        """Deterministic bulk pass over syncPolicy metrics. Each node's
        hot value is computed and patched once for the whole sweep (see
        ``sync_metric_bulk``'s ``hot_emitted``; per-metric re-patches at
        one ``now`` are identical)."""
        if now is None:
            now = time.time()
        t0 = time.perf_counter()
        hot_by_node = self.hot_values_batch(now)
        hot_emitted: set[str] = set()
        for sp in self.policy.spec.sync_period:
            self.sync_metric_bulk(
                sp.name, now, hot_by_node=hot_by_node, hot_emitted=hot_emitted
            )
        # per-sweep hot-path line, quiet by default (ref [crane]-prefix
        # convention: plugins.go:59,64 logs at klog V-levels)
        vlog(1, f"sync sweep: {len(self.policy.spec.sync_period)} metrics, "
                f"{len(hot_by_node)} hot nodes, "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms")

    # -- columnar bulk refresh ------------------------------------------

    def refresh_store(self, store: NodeLoadStore) -> None:
        """Bulk re-ingest every node's annotations into the columnar store
        (cold-start = full re-read; the store is a cache, never the source
        of truth — SURVEY §5)."""
        nodes = self.cluster.list_nodes()
        store.bulk_ingest((n.name, n.annotations) for n in nodes)
        # one lock hold for the whole prune: a concurrent snapshot() never
        # observes a half-pruned store
        store.prune_absent(n.name for n in nodes)

    # -- threaded mode -----------------------------------------------------

    def start(self) -> None:
        """Start workers, tickers, event ingestion, and heap GC
        (ref: controller.go:61-85)."""
        self._stop.clear()
        self.event_ingestor.start()
        for _ in range(self.config.concurrent_syncs):
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
            self._threads.append(t)
        for sp in self.policy.spec.sync_period:
            # immediate first sync, then the periodic ticker
            if self.config.bulk_sync:
                self.sync_metric_bulk(sp.name)
            else:
                self.enqueue_metric(sp.name)
            t = threading.Thread(target=self._ticker, args=(sp,), daemon=True)
            t.start()
            self._threads.append(t)
        t = threading.Thread(target=self._gc_loop, daemon=True)
        t.start()
        self._threads.append(t)
        if self.config.direct_store and self._store is not None:
            t = threading.Thread(target=self._anno_emitter, daemon=True)
            t.start()
            self._threads.append(t)

    def _anno_emitter(self) -> None:
        """Direct mode: drain deferred annotation patches off the sync
        path (the cluster contract catches up within ~50ms)."""
        while not self._stop.wait(timeout=0.05):
            self.flush_annotations()
        self.flush_annotations()

    def stop(self) -> None:
        self._stop.set()
        self.queue.shutdown()
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads.clear()

    def _worker(self) -> None:
        while not self._stop.is_set():
            item = self.queue.get(timeout=0.5)
            if item is None:
                continue
            try:
                forget = self.sync_node(item)
            finally:
                self.queue.done(item)
            if forget:
                self.queue.forget(item)
            else:
                self.queue.add_rate_limited(item)
                if self._m_backoff is not None:
                    self._m_backoff.inc()
            if self._m_queue_depth is not None:
                self._m_queue_depth.set(len(self.queue))

    def _ticker(self, sync_policy) -> None:
        period = max(sync_policy.period_seconds, 0.01)
        while not self._stop.wait(timeout=period):
            if self.config.bulk_sync:
                self.sync_metric_bulk(sync_policy.name)
            else:
                self.enqueue_metric(sync_policy.name)

    def _gc_loop(self) -> None:
        while not self._stop.wait(timeout=60.0):
            self.binding_records.bindings_gc()
