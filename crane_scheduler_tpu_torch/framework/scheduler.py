"""The scheduling loops: burst scheduling on one GPU, and the per-pod path.

Counterpart of ``crane_scheduler_tpu/framework/scheduler.py``.
``Scheduler`` (at the end of this module) is the per-pod ("drip") path:
the scalar plugin loop, the columnar fast path and the batched windows of
``schedule_queue`` / ``DripQueue``. ``BatchScheduler`` is the main path:
``refresh`` (the object path, or nothing in direct mode, where the
annotator writes a shared store), ``_prepare`` (resident-snapshot hit,
column-write replay, row delta, full upload), ``schedule_batch`` and
``schedule_batches_pipelined`` over ``Pod`` objects, and the columnar
``schedule_pod_burst`` / ``schedule_bursts_pipelined``. Both pipelined
loops can overlap the refresh (``_OverlappedRefresh``) and the binds
(``_BindFlushQueue``) with the next cycle; those workers touch the store
and the cluster, never a tensor. The gang entry points share it:
``schedule_gang`` (one gang through the combined-score step),
``schedule_gang_queue`` (K gangs per device window over the
version-cached ``GangColumns``, ``scorer.gang_batch``) and
``schedule_batch_mixed`` (pending pods class by class). With
``topology=`` (a ``topology.TopologyMatch``) they add the NUMA vectors
(combined-score offsets and copy capacity, ``_numa_vectors``: a cache
re-deriving only the rows the pod-change journal names), bind through
the plugin's grouped Filter/Reserve/PreBind (``_bind_assignments``) and
re-solve over-admitted copies (``_bind_recover_loop``). Placements are
bit-identical to the reference: the same solver, the same
``_expand_counts`` order.

Both schedulers take ``telemetry=`` (``crane_scheduler_tpu_torch.telemetry``)
and fall back to the process-global instance (``telemetry.active()``,
which honours ``CRANE_TELEMETRY=1``); with none, every hook is one
attribute check. With it, the stages record spans (host enqueue time:
no span waits on the device except ``d2h_wait`` and ``d2h_fetch``, which
hold the fetch's own wait), ``refresh_stats`` mirrors into registry
counters, each burst or drip decision offers a sampled trace, and a
prefix of each burst's pods (every drip pod) is lifecycle-tracked.

The Dynamic score is pod-independent, so a burst of non-DaemonSet pods
shares one score vector; placement spreads via the in-batch hot-value
penalty (see ``scorer.topk``). DaemonSet pods bypass Filter per the
reference and are scheduled individually by the caller.
"""

from __future__ import annotations

import queue
import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..cluster.state import ClusterState, Pod
from ..constants import MAX_NODE_SCORE
from ..device import resolve_device
from ..loadstore.store import NodeLoadStore
from ..parallel.sharded import ShardedScheduleStep
from ..parallel.step import EPOCH_REBASE_SECONDS, PackedFetch, ScheduleStep
from ..policy.compile import compile_policy
from ..policy.types import DynamicSchedulerPolicy
from ..scorer.topk import gang_assign_host
from ..telemetry import active as active_telemetry
from ..telemetry import StageClock, maybe_span, tracing
from ..utils.logging import verbosity, vlog
from .types import CycleState, NodeInfo

# stages of one burst cycle, in order (see ``BatchScheduler.burst_stage_ms``)
BURST_STAGES = ("refresh", "prepare", "dispatch", "add_pod_burst", "wait", "expand", "bind")

# re-solve passes of ``_bind_recover_loop`` (the reference's ``max_passes`` default)
_RECOVER_PASSES = 4


def _mesh_device(mesh, device) -> torch.device:
    """A scheduler's device: ``device``, else the mesh's first tile's. A
    ``device`` other than that first tile's is refused."""
    if mesh is None:
        return resolve_device(device)
    first = mesh.devices[0]
    if device is None:
        return first
    dev = resolve_device(device)
    if dev != first:
        raise ValueError(f"device {dev} is not the mesh's first tile device {first}")
    return dev


def _submit_fetch(pool, fetch: PackedFetch, telemetry=None) -> Future:
    """Future of a started device->host fetch: waited on the pool's worker
    when pipelining (the done-callback retrieves any exception, so an
    abandoned generator leaves none unread), inline at depth 1. With
    telemetry the worker's wait is a ``d2h_fetch`` span on its own track."""
    if pool is None:
        fut = Future()
        fut.set_result(fetch.result())
        return fut
    if telemetry is None:
        fut = pool.submit(fetch.result)
    else:
        def _fetch():
            with telemetry.spans.span("d2h_fetch"):
                return fetch.result()

        fut = pool.submit(_fetch)
    fut.add_done_callback(lambda f: f.cancelled() or f.exception())
    return fut


class _MirroredStats(dict):
    """``refresh_stats`` that folds each increment into a registry counter
    (the positive deltas: counters only rise) and stays a plain dict for
    every reader. The overlap worker's writes go through the same dict."""

    __slots__ = ("_counters",)

    def __init__(self, init: dict, counters: dict):
        super().__init__(init)
        self._counters = counters

    def __setitem__(self, key, value):
        counter = self._counters.get(key)
        if counter is not None:
            delta = value - self.get(key, 0)
            if delta > 0:
                counter.inc(delta)
        super().__setitem__(key, value)


@dataclass
class BatchResult:
    assignments: dict  # pod_key -> node name
    unassigned: list  # pod keys with no capacity
    scores: dict  # node name -> int score
    schedulable: dict  # node name -> bool
    now: float = 0.0  # scheduling time the device scored at


@dataclass
class GangOutcome:
    """One gang's outcome from ``schedule_gang_queue``: lighter than
    ``BatchResult`` (no per-node score/schedulable dicts, which would cost
    O(N) per gang)."""

    assignments: dict  # pod_key -> node name
    unassigned: list  # pod keys with no capacity
    waterline: int | None  # solver level (None on the fallback path)
    now: float
    source: str = "window"  # "window" | "fallback"


@dataclass
class BurstResult:
    """Columnar burst outcome: placements as one int32 column over a node
    table — no per-pod Python objects. ``assignments``/``unassigned``
    materialize the object-path views lazily."""

    namespace: str
    names: list  # pod names, row order
    node_idx: object  # np.int32 [len(names)], -1 = unassigned
    node_table: tuple  # node names the column indexes (immutable)
    bound_rows: object  # rows actually bound
    scores_row: object  # np int32 [n_nodes], row-aligned with node_table
    schedulable_row: object  # np bool [n_nodes]
    now: float = 0.0

    @property
    def n_assigned(self) -> int:
        return int(np.count_nonzero(np.asarray(self.node_idx) >= 0))

    @property
    def assignments(self) -> dict:
        ns = self.namespace
        table = self.node_table
        idx = np.asarray(self.node_idx)
        return {
            f"{ns}/{self.names[row]}": table[int(idx[row])]
            for row in np.nonzero(idx >= 0)[0]
        }

    @property
    def unassigned(self) -> list:
        ns = self.namespace
        idx = np.asarray(self.node_idx)
        return [f"{ns}/{self.names[int(r)]}" for r in np.nonzero(idx < 0)[0]]


class _OverlappedRefresh:
    """Double-buffered store refresh for the pipelined loops: ``tick()``
    starts a background ``BatchScheduler.refresh()`` when none is in
    flight and returns without waiting, so ``_prepare`` consumes the store
    state of the last completed ingest. The first tick blocks (a cold
    scheduler must not score an empty store); a worker's exception
    surfaces on a later tick. The store's lock makes the concurrent ingest
    safe; ``_prepare`` keys the device snapshot on the version read with
    the data."""

    def __init__(self, scheduler: "BatchScheduler"):
        self._scheduler = scheduler
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="overlap-refresh")
        self._fut: Future | None = None
        self._first = True

    def tick(self) -> None:
        sched = self._scheduler
        if self._first:
            self._first = False
            self._pool.submit(sched.refresh).result()
            return
        fut = self._fut
        if fut is not None:
            if not fut.done():
                # ingest still in flight: score the last completed state
                sched.refresh_stats["overlap_hits"] += 1
                return
            self._fut = None
            fut.result()  # surface worker errors, at most one tick late
        self._fut = self._pool.submit(sched.refresh)

    def close(self) -> None:
        # never block loop teardown on an in-flight ingest: it drains in
        # the background against a store that outlives this loop
        self._pool.shutdown(wait=False, cancel_futures=True)


def _burst_posted_pairs(tracked, node_idx, table):
    """``(key, node)`` pairs for the lifecycle-tracked prefix of a burst
    whose rows got a node (after reconciling with what bound)."""
    pairs = []
    for i, key in enumerate(tracked):
        idx = int(node_idx[i])
        if idx >= 0:
            pairs.append((key, table[idx]))
    return pairs


class _BindFlushQueue:
    """Coalescing, overlapped bind flush for the pipelined loops: binds
    accumulate for up to a small time/size window, each window flushes as
    one transaction per kind (``bind_pods`` for batches; the window's
    ``add_pod_burst`` creations, then ``bind_burst`` for bursts) on a
    background worker, and the scheduling thread does not wait for it. A
    yielded result's bind fields (``bound_rows``/``node_idx``,
    ``assignments``/``unassigned``) settle when its window flushes;
    consuming the generator to the end settles everything."""

    _MAX_WINDOW_PODS = 200_000  # a window flushes early at this size

    def __init__(self, scheduler: "BatchScheduler", window_s: float = 0.005):
        self._scheduler = scheduler
        self._window = float(window_s)
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._outstanding = 0
        self._outstanding_pods = 0  # un-flushed pods (watermark signal)
        self._lock = threading.Lock()
        self._drained = threading.Condition(self._lock)
        self._error: BaseException | None = None
        self.stats = {"windows": 0, "flushed_pods": 0, "max_window_pods": 0}
        tel = scheduler._telemetry
        self._m_window_pods = self._m_window_seconds = None
        if tel is not None:
            reg = tel.registry
            self._m_window_pods = reg.histogram(
                "crane_bind_flush_window_pods",
                "Pods coalesced into one bind flush window",
            )
            self._m_window_seconds = reg.histogram(
                "crane_bind_flush_window_seconds",
                "Open time of each bind flush window",
            )
        self._worker = threading.Thread(target=self._run, daemon=True, name="bind-flush")
        self._worker.start()

    # -- producer side (scheduling thread) --------------------------------

    def submit_batch(self, result: "BatchResult", now: float, tracked=()) -> None:
        with self._lock:
            self._outstanding += 1
            self._outstanding_pods += len(result.assignments)
        self._q.put(("batch", result, now, tracked))

    def submit_burst(self, namespace: str, names: list, node_table, node_idx,
                     result: "BurstResult", now: float, tracked=()) -> None:
        with self._lock:
            self._outstanding += 1
            self._outstanding_pods += len(names)
        self._q.put(("burst", namespace, names, node_table, node_idx, result, now, tracked))

    def wait_below(self, watermark: int) -> None:
        """Backpressure: block the producer until the un-flushed pod depth
        drops below ``watermark``; a worker error returns at once
        (``flush`` raises it)."""
        with self._drained:
            while self._outstanding_pods >= max(1, int(watermark)) and self._error is None:
                self._drained.wait(timeout=0.5)

    def flush(self) -> None:
        """Block until every submitted bind has flushed; re-raise a worker
        error (binds must not fail silently)."""
        with self._drained:
            while self._outstanding > 0:
                self._drained.wait(timeout=0.5)
            if self._error is not None:
                err, self._error = self._error, None
                raise err

    def close(self) -> None:
        try:
            self.flush()
        finally:
            self._q.put(None)
            self._worker.join(timeout=5.0)

    # -- worker side -------------------------------------------------------

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            window = [item]
            pods = self._item_pods(item)
            t0 = time.perf_counter()
            # keep accumulating while more cycles' binds arrive, up to the
            # window deadline or the size cap
            while pods < self._MAX_WINDOW_PODS:
                remaining = self._window - (time.perf_counter() - t0)
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._flush_window(window, time.perf_counter() - t0)
                    return
                window.append(nxt)
                pods += self._item_pods(nxt)
            self._flush_window(window, time.perf_counter() - t0)

    @staticmethod
    def _item_pods(item) -> int:
        if item[0] == "batch":
            return len(item[1].assignments)
        return len(item[2])

    def _flush_window(self, window: list, open_seconds: float) -> None:
        count = sum(self._item_pods(i) for i in window)
        try:
            with maybe_span(self._scheduler._telemetry, "bind_flush", pods=count,
                            cycles=len(window)):
                self._flush_window_inner(window)
        except BaseException as exc:  # noqa: BLE001 — surfaced by flush()
            with self._lock:
                self._error = exc
        finally:
            self.stats["windows"] += 1
            self.stats["flushed_pods"] += count
            self.stats["max_window_pods"] = max(self.stats["max_window_pods"], count)
            vlog(1, f"bind flush window: {count} pods across {len(window)} "
                    f"cycles, open {open_seconds * 1e3:.1f} ms")
            if self._m_window_pods is not None:
                self._m_window_pods.observe(count)
                self._m_window_seconds.observe(open_seconds)
            with self._drained:
                self._outstanding -= len(window)
                self._outstanding_pods = max(0, self._outstanding_pods - count)
                self._drained.notify_all()

    def _flush_window_inner(self, window: list) -> None:
        cluster = self._scheduler.cluster
        lc = self._scheduler._lifecycle
        batches = [i for i in window if i[0] == "batch"]
        bursts = [i for i in window if i[0] == "burst"]
        posted = []  # (key, node) of the tracked pods that bound
        if batches:
            # one merged bind transaction for the window's batch results
            merged: dict = {}
            for _, result, _now, _tr in batches:
                merged.update(result.assignments)
            bound = set(cluster.bind_pods(merged, batches[-1][2]))
            for _, result, _now, tracked in batches:
                failed = [k for k in result.assignments if k not in bound]
                for k in failed:
                    del result.assignments[k]
                result.unassigned.extend(failed)
                posted.extend((k, result.assignments[k]) for k in tracked
                              if k in result.assignments)
        if bursts:
            # creations first (a bind of an uncreated pod is refused)
            handles = [cluster.add_pod_burst(ns, names)
                       for _, ns, names, _t, _i, _r, _n, _tr in bursts]
            now = bursts[-1][6]
            for handle, (_, _ns, _names, table, node_idx, result, _now, tracked) in zip(
                    handles, bursts):
                bound = cluster.bind_burst(handle, table, node_idx, now)
                result.bound_rows = bound
                node_idx = np.asarray(result.node_idx)
                if len(bound) != int((node_idx >= 0).sum()):
                    mask = np.zeros((len(node_idx),), dtype=bool)
                    mask[bound] = True
                    result.node_idx = np.where(mask, node_idx, -1).astype(np.int32)
                posted.extend(_burst_posted_pairs(tracked, np.asarray(result.node_idx), table))
        if posted:
            lc.posted_batch(posted)


class BatchScheduler:
    """GPU burst mode: bulk refresh -> fused score -> gang assign -> bind."""

    def __init__(
        self,
        cluster: ClusterState,
        policy: DynamicSchedulerPolicy,
        dtype=None,
        clock=time.time,
        snapshot_bucket: int = 2048,
        store: NodeLoadStore | None = None,
        refresh_from_cluster: bool = True,
        telemetry=None,
        device=None,
        mesh=None,
    ):
        """``dtype``: ``torch.float64`` (default) is the parity mode;
        ``torch.float32`` is the fast mode, always hybrid (f64 rescue rows)
        so placements stay bit-identical to f64/Go.
        ``store``/``refresh_from_cluster``: direct mode. Pass a store the
        annotator writes (``bulk_set_by_name``, ``set_metric``) with
        ``refresh_from_cluster=False`` and ``refresh`` re-ingests nothing;
        the store's versions still drive the device snapshot.
        ``device``: ``None`` means the GPU (raises without one); tests pass
        ``"cpu"``. ``telemetry``: a ``Telemetry`` bundle, else the
        process-global one (``telemetry.active()``), else none.
        ``mesh``: a node mesh (``parallel.mesh.make_node_mesh``); the burst,
        gang, NUMA and mixed steps then run ``ShardedScheduleStep`` with the
        node axis tiled over it (K1 and K2 once per tile), placements
        unchanged. Without ``device`` its first tile's device is the
        scheduler's; the gang window and the NUMA evaluation run there."""
        self.cluster = cluster
        self.policy = policy
        self.tensors = compile_policy(policy)
        if store is not None and store.tensors is not self.tensors:
            # a shared store must be policy-compatible: metric columns are
            # positional
            if store.tensors.metric_names != self.tensors.metric_names:
                raise ValueError("shared store was built for a different policy")
        self.store = store if store is not None else NodeLoadStore(self.tensors)
        self._refresh_from_cluster = refresh_from_cluster
        self._clock = clock
        self._bucket = snapshot_bucket
        self.device = _mesh_device(mesh, device)
        self._mesh = mesh
        tel = self._telemetry = telemetry if telemetry is not None else active_telemetry()
        self._dtype = dtype or torch.float64
        self._step = self._new_step()
        self._hybrid = self._step.hybrid
        self.scorer = self._step.scorer
        self.gang = self._step.gang
        # which upload path served each _prepare call
        stats = {
            "hit": 0,  # unchanged store, resident snapshot reused
            "columns": 0,  # column-log replay ([N] vectors per column)
            "delta": 0,  # row-delta scatter
            "full": 0,  # full snapshot + H2D upload
            "ingest_ms": 0.0,  # host ms spent in refresh() bulk ingest
            "risk_rescan_rows": 0,  # rows the hybrid f64 risk scan touched
            # pipelined cycles served without waiting for an in-flight
            # background refresh (overlap_refresh)
            "overlap_hits": 0,
            # refreshes from a kube mirror's decoded LIST columns, and those
            # narrowed to its dirty-name journal: 0 until the port's
            # cluster keeps either
            "columnar_ingest": 0,
            "dirty_ingest": 0,
        }
        self.refresh_stats = stats if tel is None else _MirroredStats(
            stats, self._stats_counters(tel.registry)
        )
        self._last_refresh_wall = 0.0  # decision-trace staleness anchor
        # newest hot-value timestamp in the store: which annotator sync fed
        # the scores a cycle consumed (lifecycle records carry it)
        self.last_anno_ts: float | None = None
        self._lifecycle = tel.lifecycle if tel is not None else None
        # the allocatable accounting behind the gang solver's capacity
        # floor, on this scheduler's registry (``fit`` imports this
        # package's types, so it loads here)
        from ..fit.tracker import FitTracker

        self._fit = FitTracker(cluster, telemetry=tel)
        self._fit_names: tuple | None = None  # (names_ref, n, list) reuse
        self._combined: dict = {}  # (dyn_w, topo_w) -> combined-score step
        # cached NUMA vectors: a full build is an O(N) Python wrapper build,
        # so repeated gang cycles re-derive only journaled (changed) rows
        self._numa_cache: dict = {}
        self.numa_incremental_rows = 0  # rows re-derived incrementally
        # the multi-gang engine (scorer.gang_batch + framework.drip.
        # GangColumns), built lazily per weight/label config by
        # _ensure_gang; _gang holds the window distributions gang_stats()
        # exposes
        self._gang_engine = None
        self._gang = {"windows": 0, "gangs": 0, "pods": 0, "fallbacks": 0,
                      "window_sizes": [], "kernel_seconds": []}
        self._m_gang_pods = self._m_gang_kernel = None
        if tel is not None:
            self._m_gang_pods = tel.registry.histogram(
                "crane_gang_dispatch_pods", "Pods per gang dispatch window",
                buckets=(8, 16, 32, 64, 128, 256, 512, 1024, 2048),
            )
            self._m_gang_kernel = tel.registry.histogram(
                "crane_gang_kernel_seconds", "Gang window solve wall seconds per dispatch",
                buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 1.0),
            )
        self._prepared = None  # resident PreparedSnapshot
        self._prepared_key = None  # store version it was built from
        self._prepared_layout = None  # store layout version it was built from
        self._prepared_snap = None  # host snapshot behind it (hybrid only)
        self._prepared_names: tuple[str, ...] = ()
        self._prepared_n = 0
        self._rescan_counted = None
        self._node_table_cache = None
        # the columnar refresh's fences: the column version last ingested,
        # and the cluster node fence at that ingest (keys the dirty-name
        # lookup that narrows the next columnar ingest)
        self._columns_consumed = None
        self._ingest_node_ver: int | None = None
        # host ms per stage of the burst cycle, summed over bursts (reset
        # by assigning a fresh ``dict.fromkeys(BURST_STAGES, 0.0)``). No
        # device syncs: "dispatch" is the step's launch cost and "wait"
        # holds whatever device and copy time the host did not overlap.
        self.burst_stage_ms = dict.fromkeys(BURST_STAGES, 0.0)
        # the bind-flush windows of the last pipelined run with
        # overlap_bind (``_BindFlushQueue.stats``), else None
        self.bind_flush_stats = None

    @staticmethod
    def _stats_counters(reg) -> dict:
        """The registry counter each ``refresh_stats`` key folds into."""
        path = reg.counter(
            "crane_refresh_path_total", "Which upload path served each _prepare call",
            ("path",),
        )
        counters = {k: path.labels(path=k) for k in ("hit", "columns", "delta", "full")}
        counters["ingest_ms"] = reg.counter(
            "crane_refresh_ingest_ms_total", "Host milliseconds spent in refresh() bulk ingest",
        )
        counters["risk_rescan_rows"] = reg.counter(
            "crane_risk_rescan_rows_total", "Rows the hybrid f64 risk rescan touched",
        )
        counters["overlap_hits"] = reg.counter(
            "crane_overlap_hits_total",
            "Pipelined cycles served without blocking on an in-flight background refresh",
        )
        counters["columnar_ingest"] = reg.counter(
            "crane_refresh_columnar_ingest_total",
            "Store refreshes served straight from decoded LIST columns "
            "(no Node-object round-trip)",
        )
        counters["dirty_ingest"] = reg.counter(
            "crane_refresh_dirty_ingest_total",
            "Columnar ingests narrowed to the dirty-name journal",
        )
        return counters

    def _stage(self, name: str, t0: float) -> float:
        t = time.perf_counter()
        self.burst_stage_ms[name] += (t - t0) * 1e3
        return t

    def refresh(self) -> None:
        """Bulk re-ingest node annotations (the store is a cache). A
        direct-mode store skips this: the annotator keeps it current.

        When the cluster is a kube mirror with decoded LIST columns
        (``node_annotation_columns``), they feed the store directly
        (``ingest_annotation_columns``): no Node objects, no per-node
        dict walk. The columns carry a version, so an unchanged mirror
        costs nothing, and when the dirty-name journal covers the gap
        since the last ingest with no membership change, only the dirty
        rows are written. Without columns, the object sweep below."""
        if not self._refresh_from_cluster:
            self._update_anno_ts()  # the annotator owns the store
            return
        t0 = time.perf_counter()
        with maybe_span(self._telemetry, "ingest"):
            # fence BEFORE the column snapshot: a write landing between
            # the two reads re-processes next refresh instead of being
            # skipped
            node_ver = getattr(self.cluster, "node_version", None)
            cols_fn = getattr(self.cluster, "node_annotation_columns", None)
            cols = cols_fn() if cols_fn is not None else None
            if cols is not None:
                version, names, keys, values, offsets = cols
                if version != self._columns_consumed:
                    only = None
                    dirty_fn = getattr(self.cluster, "dirty_nodes_since", None)
                    if dirty_fn is not None and self._ingest_node_ver is not None:
                        d = dirty_fn(self._ingest_node_ver)
                        if d is not None and not d[1]:
                            # the journal covers the gap and membership is
                            # untouched: patch only the dirty rows
                            only = d[0]
                    self.store.ingest_annotation_columns(
                        names, keys, values, offsets, only_names=only
                    )
                    if only is None:
                        self.store.prune_absent(names)
                    else:
                        self.refresh_stats["dirty_ingest"] += 1
                    self._columns_consumed = version
                    self._ingest_node_ver = node_ver
                    self.refresh_stats["columnar_ingest"] += 1
            else:
                self._columns_consumed = None
                self._ingest_node_ver = node_ver  # the full sweep covers it
                nodes = self.cluster.list_nodes()
                self.store.bulk_ingest((n.name, n.annotations) for n in nodes)
                self.store.prune_absent(n.name for n in nodes)
        self.refresh_stats["ingest_ms"] += (time.perf_counter() - t0) * 1e3
        self._update_anno_ts()
        self._last_refresh_wall = self._clock()

    def _update_anno_ts(self) -> None:
        """Track the newest hot-value timestamp in the store (the
        annotator stamps one per sweep): one max over the host column,
        only with telemetry."""
        if self._telemetry is None:
            return
        n = len(self.store)
        if n:
            ts = float(self.store.hot_ts[:n].max())
            if ts > float("-inf"):
                self.last_anno_ts = ts

    def _note_rescan(self) -> None:
        """Fold the latest override refresh's scanned rows into
        ``refresh_stats`` — once per refreshed PreparedSnapshot."""
        p = self._prepared
        if p is None or p.ovr_mask is None or p is self._rescan_counted:
            return
        self._rescan_counted = p
        self.refresh_stats["risk_rescan_rows"] += int(p.ovr_rescan_rows)

    # Delta uploads pay off only while the changes are sparse: past this
    # fraction of rows a full upload is cheaper than the scatter.
    _DELTA_MAX_FRACTION = 0.25

    def _prepare(self, now: float):
        """Upload (or reuse) the device snapshot for the current store.

        An unchanged store reuses the resident snapshot (in hybrid mode
        refreshing the f64 rescue vectors for ``now``, which also
        re-rebases an over-aged f32 snapshot). A changed store with an
        unchanged row layout replays the store's column writes
        (``ScheduleStep.apply_columns``) or scatters the changed rows
        (``apply_delta``); in hybrid mode the same writes fold into the
        host snapshot and only their rows are rescanned. Anything else,
        or a rebased snapshot older than ``EPOCH_REBASE_SECONDS``, takes
        a full snapshot and upload."""
        step = self._step
        key = self.store.version
        # the delta and column paths keep the snapshot's epoch: an
        # over-aged one must take a full prepare (the hit path re-rebases
        # inside with_overrides)
        stale_epoch = (
            self._prepared is not None
            and self._hybrid
            and abs(float(now) - self._prepared.epoch) > EPOCH_REBASE_SECONDS
        )
        if self._prepared is not None and self._prepared_key == key:
            self.refresh_stats["hit"] += 1
            if self._hybrid:
                self._prepared = step.with_overrides(
                    self._prepared, self._prepared_snap, now
                )
                self._note_rescan()
            return self._prepared

        if (
            not stale_epoch
            and self._prepared is not None
            and self._prepared_layout == self.store.layout_version
        ):
            # column-write replay first: the annotator's sweep is
            # whole-column writes, [N] vectors per touched column
            cols = self.store.column_delta_since(self._prepared_key)
            if cols is not None:
                new_key, layout, entries = cols
                if layout == self._prepared_layout and entries:
                    self.refresh_stats["columns"] += 1
                    self._prepared = step.apply_columns(
                        self._prepared, entries, self._prepared_n
                    )
                    self._prepared_key = new_key
                    if self._hybrid:
                        # fold the same writes into the host snapshot
                        # (a re-snapshot could see newer data than the
                        # device rows), then rescan the touched rows
                        snap = self._prepared_snap
                        for col, ids, v, t, hv, ht in entries:
                            if col is not None:
                                snap.values[ids, col] = v
                                snap.ts[ids, col] = t
                            if hv is not None:
                                snap.hot_value[ids] = hv
                                snap.hot_ts[ids] = ht
                        dirty = np.unique(np.concatenate([e[1] for e in entries]))
                        self._prepared = step.with_overrides(
                            self._prepared, snap, now, force=True, dirty_rows=dirty
                        )
                        self._note_rescan()
                    return self._prepared

            (new_key, layout, rows, values_rows, ts_rows, hot_rows,
             hot_ts_rows) = self.store.delta_since(self._prepared_key)
            limit = max(1, int(self._prepared_n * self._DELTA_MAX_FRACTION))
            if layout == self._prepared_layout and 0 < len(rows) <= limit:
                self.refresh_stats["delta"] += 1
                self._prepared = step.apply_delta(
                    self._prepared, rows, values_rows, ts_rows, hot_rows, hot_ts_rows
                )
                self._prepared_key = new_key
                if self._hybrid:
                    snap = self._prepared_snap
                    snap.values[rows] = values_rows
                    snap.ts[rows] = ts_rows
                    snap.hot_value[rows] = hot_rows
                    snap.hot_ts[rows] = hot_ts_rows
                    self._prepared = step.with_overrides(
                        self._prepared, snap, now, force=True, dirty_rows=rows
                    )
                    self._note_rescan()
                return self._prepared

        self.refresh_stats["full"] += 1
        snap = self.store.snapshot(bucket=self._bucket)
        self._prepared = step.prepare(snap, now)
        self._note_rescan()
        # keyed on the versions read with the data, under one lock hold
        self._prepared_key = snap.version
        self._prepared_layout = snap.layout_version
        # only hybrid override refreshes re-read the host snapshot
        self._prepared_snap = snap if self._hybrid else None
        self._prepared_names = snap.node_names
        self._prepared_n = snap.n_nodes
        return self._prepared

    def schedule_batch(self, pods: list[Pod], bind: bool = True) -> BatchResult:
        tel = self._telemetry
        lc = self._lifecycle
        now = self._clock()
        ctx = tracing.new_context() if tel is not None else None
        with tracing.use(ctx):
            self.refresh()
            with maybe_span(tel, "prepare"):
                prepared = self._prepare(now)
            with maybe_span(tel, "exec_fetch", pods=len(pods)):
                # the cycle's single device->host fetch
                packed = self._step.packed(prepared, len(pods), now=now).result()
            keys = [pod.key() for pod in pods]
            tracked = lc.seen_batch(keys) if lc is not None else ()
            result = self._build_result(packed, keys, now=now)
            self._mark_scored(tracked, ctx)
            if bind:
                with maybe_span(tel, "bind_flush"):
                    self._apply_binds(result, now)
                self._mark_posted_batch(tracked, result)
        if verbosity() >= 2:
            vlog(2, f"batch cycle: {len(result.assignments)}/{len(pods)} "
                    f"assigned, {len(result.unassigned)} unassigned")
        return result

    def _mark_scored(self, tracked, ctx) -> None:
        """Lifecycle ``scored`` for a cycle's tracked pods, with the cycle's
        trace id and the annotator sync that fed its scores."""
        if tracked:
            self._lifecycle.stage_batch(
                tracked, "scored",
                cycle_trace=ctx.trace_id if ctx is not None else None,
                anno_ts=self.last_anno_ts,
            )

    def _mark_posted_batch(self, tracked, result: BatchResult) -> None:
        if tracked:
            self._lifecycle.posted_batch(
                [(k, result.assignments[k]) for k in tracked if k in result.assignments]
            )

    def _apply_binds(self, result: BatchResult, now: float) -> None:
        """Bind the batch; keys ``bind_pods`` could not bind move to
        ``unassigned``."""
        bound = set(self.cluster.bind_pods(result.assignments, now))
        if len(bound) != len(result.assignments):
            failed = [k for k in result.assignments if k not in bound]
            for k in failed:
                del result.assignments[k]
            result.unassigned.extend(failed)

    def schedule_batches_pipelined(self, batches, bind: bool = True, depth: int = 4,
                                   overlap_refresh: bool = False,
                                   overlap_bind: bool = False,
                                   bind_window_s: float = 0.005,
                                   bind_watermark_pods: int | None = None):
        """Pipelined batches of ``Pod`` objects: ``batches`` yields pod
        lists; one ``BatchResult`` per batch, in order. Up to ``depth``
        cycles are dispatched ahead, each with its device->host copy
        started at dispatch; at depth > 1 one worker thread waits on the
        copies. A cycle's snapshot cannot see the previous ``depth - 1``
        cycles' binds (bounded feedback lag, as in the reference). This is
        a generator: nothing is dispatched until it is iterated.

        ``overlap_refresh``: the cluster re-ingest runs on a background
        worker and each cycle scores the last completed store state
        (``refresh_stats["overlap_hits"]`` counts the cycles that did not
        wait). ``overlap_bind``: binds go through a coalescing background
        flush (windows of up to ``bind_window_s``); a result's bind fields
        settle when its window flushes, and consuming the generator to
        the end settles every result. ``bind_watermark_pods``: with
        ``overlap_bind``, pause dispatch while at least that many pods
        wait to be flushed."""
        yield from self._pipelined(
            ((None, pods) for pods in batches), self._dispatch_batch,
            self._drain_pipelined, bind, depth, overlap_refresh, overlap_bind,
            bind_window_s, bind_watermark_pods,
        )

    def _dispatch_batch(self, pool, item, now: float, t: float, bind: bool, bindq, ctx):
        _, pods = item
        tel = self._telemetry
        with maybe_span(tel, "prepare"):
            prepared = self._prepare(now)
        t = self._stage("prepare", t)
        with maybe_span(tel, "dispatch", pods=len(pods)):
            fetch = self._step.packed(prepared, len(pods), now=now)
        self._stage("dispatch", t)
        keys = [pod.key() for pod in pods]
        lc = self._lifecycle
        tracked = lc.seen_batch(keys) if lc is not None else ()
        return (_submit_fetch(pool, fetch, tel), keys, now,
                self._prepared_names, self._prepared_n, tracked, ctx)

    def _drain_pipelined(self, pending, bind: bool, bindq=None) -> BatchResult:
        fut, keys, now, names, n, tracked, ctx = pending
        tel = self._telemetry
        with tracing.use(ctx):
            with maybe_span(tel, "d2h_wait"):
                packed = fut.result()  # the only synchronization point
            result = self._build_result(packed, keys, now=now, names=names, n=n)
            self._mark_scored(tracked, ctx)
            if bind:
                if bindq is not None:
                    bindq.submit_batch(result, now, tracked)
                else:
                    with maybe_span(tel, "bind_flush"):
                        self._apply_binds(result, now)
                    self._mark_posted_batch(tracked, result)
        return result

    # -- columnar bursts (pods as rows, binds as one array transaction) ----

    def schedule_pod_burst(self, namespace: str, names: list, bind: bool = True) -> BurstResult:
        """Schedule a burst of bare pods as one column: placements come
        back as an int32 column, binds apply through
        ``ClusterState.bind_burst`` in one transaction. Placement-identical
        to ``schedule_batch`` over equivalent ``Pod`` objects."""
        for result in self.schedule_bursts_pipelined([(namespace, names)], bind=bind, depth=1):
            return result
        raise RuntimeError("empty burst stream")  # pragma: no cover

    def schedule_bursts_pipelined(self, bursts, bind: bool = True, depth: int = 4,
                                  overlap_refresh: bool = False,
                                  overlap_bind: bool = False,
                                  bind_window_s: float = 0.005,
                                  bind_watermark_pods: int | None = None):
        """Pipelined columnar bursts: ``bursts`` yields ``(namespace,
        names)`` pairs; one ``BurstResult`` per burst, in order. The same
        dispatch/drain overlap, feedback lag and options as
        ``schedule_batches_pipelined``; with ``overlap_bind`` the burst's
        creation rides the flush worker too, before its bind."""
        yield from self._pipelined(
            bursts, self._dispatch_burst, self._drain_burst, bind, depth,
            overlap_refresh, overlap_bind, bind_window_s, bind_watermark_pods,
        )

    def _dispatch_burst(self, pool, item, now: float, t: float, bind: bool, bindq, ctx):
        namespace, names = item
        tel = self._telemetry
        with maybe_span(tel, "prepare"):
            prepared = self._prepare(now)
        t = self._stage("prepare", t)
        with maybe_span(tel, "dispatch", pods=len(names)):
            fetch = self._step.packed(prepared, len(names), now=now)
        t = self._stage("dispatch", t)
        # with a bind queue the creation rides the flush worker, ordered
        # before the bind on its FIFO
        handle = self.cluster.add_pod_burst(namespace, names) if bind and bindq is None else None
        self._stage("add_pod_burst", t)
        # a prefix sample is lifecycle-tracked; tracked[i] is row i
        lc = self._lifecycle
        tracked = (
            lc.seen_batch([f"{namespace}/{nm}" for nm in names[:lc.batch_sample]],
                          source="burst")
            if lc is not None else ()
        )
        return (_submit_fetch(pool, fetch, tel), namespace, names, handle, now,
                self._prepared_names, self._prepared_n, tracked, ctx)

    def _pipelined(self, items, dispatch, drain, bind: bool, depth: int,
                   overlap_refresh: bool, overlap_bind: bool,
                   bind_window_s: float, bind_watermark_pods):
        """The loop both pipelined entry points share: per item refresh
        (or an overlapped refresh tick), ``dispatch`` (prepare, launch,
        start the fetch), and ``drain`` once ``depth`` cycles are in
        flight. All cluster mutation stays on this thread unless
        ``overlap_bind`` hands the binds to the flush worker."""
        if depth < 1:
            raise ValueError("depth must be >= 1")
        refresher = (
            _OverlappedRefresh(self) if overlap_refresh and self._refresh_from_cluster else None
        )
        bindq = _BindFlushQueue(self, window_s=bind_window_s) if bind and overlap_bind else None
        pending = deque()
        # the prefix names the worker's span track ("d2h-prefetch_0")
        pool = (
            ThreadPoolExecutor(max_workers=1, thread_name_prefix="d2h-prefetch")
            if depth > 1 else None
        )
        self.bind_flush_stats = bindq.stats if bindq is not None else None
        tel = self._telemetry
        try:
            for item in items:
                if bindq is not None and bind_watermark_pods:
                    bindq.wait_below(bind_watermark_pods)
                now = self._clock()
                t = time.perf_counter()
                # one trace per cycle: lifecycle records join the cycle
                # that scored them (``cycle_trace``)
                ctx = tracing.new_context() if tel is not None else None
                with tracing.use(ctx):
                    with maybe_span(tel, "refresh_tick"):
                        if refresher is not None:
                            refresher.tick()
                        else:
                            self.refresh()
                    t = self._stage("refresh", t)
                    pending.append(dispatch(pool, item, now, t, bind, bindq, ctx))
                if len(pending) >= depth:
                    yield drain(pending.popleft(), bind, bindq)
            while pending:
                yield drain(pending.popleft(), bind, bindq)
        finally:
            if bindq is not None:
                bindq.close()  # settles every yielded result's bind fields
            if refresher is not None:
                refresher.close()
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)

    def _drain_burst(self, item, bind: bool, bindq=None) -> BurstResult:
        fut, namespace, names, handle, now, node_names, n, tracked, ctx = item
        tel = self._telemetry
        with tracing.use(ctx):
            t = time.perf_counter()
            with maybe_span(tel, "d2h_wait"):
                packed = fut.result()  # the only synchronization point
            t = self._stage("wait", t)
            schedulable, scores, counts, _unassigned, _ = ScheduleStep.unpack(packed, n)
            scores = np.asarray(scores)
            counts = np.asarray(counts)
            # same stable score-descending expansion as _expand_counts, kept
            # columnar: order[i] is pod-row i's node row
            by_score = np.argsort(-scores, kind="stable")
            order = np.repeat(by_score, counts[by_score]).astype(np.int32)
            node_idx = np.full((len(names),), -1, dtype=np.int32)
            k = min(len(order), len(names))
            node_idx[:k] = order[:k]
            table = self._burst_node_table(node_names, n)
            if tel is not None:
                self._trace_batch_decision(tel, scores, schedulable, counts, n, node_names,
                                           len(names), now, source="burst")
            self._mark_scored(tracked, ctx)
            t = self._stage("expand", t)
            bound = None
            if bind and handle is not None:
                with maybe_span(tel, "bind_flush"):
                    bound = self.cluster.bind_burst(handle, table, node_idx, now)
                if len(bound) != int((node_idx >= 0).sum()):
                    # reconcile with what actually bound (rows deleted between
                    # dispatch and drain)
                    mask = np.zeros((len(names),), dtype=bool)
                    mask[bound] = True
                    node_idx = np.where(mask, node_idx, -1).astype(np.int32)
                if tracked:
                    self._lifecycle.posted_batch(_burst_posted_pairs(tracked, node_idx, table))
            result = BurstResult(
                namespace=namespace,
                names=names,
                node_idx=node_idx,
                node_table=table,
                bound_rows=bound,
                scores_row=scores,
                schedulable_row=np.asarray(schedulable),
                now=now,
            )
            if bind and bindq is not None:
                # creation + bind run on the flush worker; bound_rows and
                # node_idx settle when the window flushes
                bindq.submit_burst(namespace, names, table, node_idx, result, now, tracked)
            self._stage("bind", t)
            return result

    def _burst_node_table(self, node_names, n: int) -> tuple:
        """The burst's node table as a stable, immutable tuple cached on
        the prepared snapshot's names tuple: bursts sharing one snapshot
        reuse one object, so ``bind_burst``'s identity-keyed caches hit."""
        cache = self._node_table_cache
        if cache is None or cache[0] is not node_names or cache[1] != n:
            cache = (node_names, n, tuple(node_names[:n]))
            self._node_table_cache = cache
        return cache[2]

    @staticmethod
    def _expand_counts(scores, counts, names, keys):
        """Expand per-node counts into pod-key assignments: nodes in
        stable score-descending order, keys in sequence; keys beyond the
        total count are unassigned."""
        by_score = np.argsort(-np.asarray(scores), kind="stable")
        counts = np.asarray(counts)
        order = np.repeat(by_score, counts[by_score])
        assignments = {
            key: names[node_idx] for key, node_idx in zip(keys, order)
        }
        unassigned = list(keys[len(order):])
        return assignments, unassigned

    def _trace_batch_decision(self, tel, scores, schedulable, counts, n, names, num_pods,
                              now, source: str) -> None:
        """Offer one sampled decision trace for a whole batch or burst (its
        pods are interchangeable: the cycle is the decision): the top-5
        scores with their placement counts, the feasible-node count and the
        age of the last completed ingest. Reads the unpacked host arrays
        only; the argpartition runs only when the stride keeps the entry."""

        def _build():
            body = np.asarray(scores[:n])
            k = min(5, n)
            idx = np.argpartition(-body, k - 1)[:k] if n > k else np.arange(n)
            idx = idx[np.argsort(-body[idx], kind="stable")]
            assigned = int(np.asarray(counts[:n]).sum())
            return {
                "pod": f"{source}[{num_pods}]",
                "node": None,
                "reason": "" if assigned >= num_pods else f"{num_pods - assigned} unassigned",
                "feasible": int(np.asarray(schedulable[:n]).sum()),
                "top_scores": [(names[int(i)], int(body[int(i)])) for i in idx],
                "staleness_seconds": (
                    now - self._last_refresh_wall if self._last_refresh_wall else -1.0
                ),
                "source": source,
                "counts_top": {
                    names[int(i)]: int(counts[int(i)]) for i in idx if int(counts[int(i)])
                },
            }

        tel.decisions.offer(_build)

    def _build_result(self, packed, keys, now: float, names=None, n=None) -> BatchResult:
        """Host result of one batch; ``names``/``n`` default to the current
        prepared snapshot (the pipelined loop passes the values captured
        at dispatch)."""
        if names is None:
            names, n = self._prepared_names, self._prepared_n
        schedulable, scores, counts, _unassigned, _ = ScheduleStep.unpack(packed, n)
        if self._telemetry is not None:
            self._trace_batch_decision(self._telemetry, scores, schedulable, counts, n, names,
                                       len(keys), now, source="batch")
        assignments, unassigned = self._expand_counts(scores, counts, names, keys)
        return BatchResult(
            assignments=assignments,
            unassigned=unassigned,
            scores={names[i]: int(scores[i]) for i in range(n)},
            schedulable={names[i]: bool(schedulable[i]) for i in range(n)},
            now=now,
        )

    # -- gangs: combined plugin scoring and the multi-gang window ------------

    def _new_step(self, **kw) -> ScheduleStep:
        """A score + gang step: on the mesh when there is one."""
        if self._mesh is not None:
            return ShardedScheduleStep(self.tensors, self._mesh, dtype=self._dtype,
                                       telemetry=self._telemetry, **kw)
        return ScheduleStep(self.tensors, dtype=self._dtype, device=self.device,
                            telemetry=self._telemetry, **kw)

    def _combined_step(self, dynamic_weight: int, topology_weight: int) -> ScheduleStep:
        """The score + gang step in the combined-score domain (Dynamic x
        ``dynamic_weight`` plus offsets up to ``100 x topology_weight``),
        one per weight pair in a bounded LRU."""
        key = (dynamic_weight, topology_weight)
        step = self._combined.get(key)
        if step is None:
            step = self._new_step(dynamic_weight=dynamic_weight,
                                  max_offset=MAX_NODE_SCORE * topology_weight)
            while len(self._combined) >= 8:
                self._combined.pop(next(iter(self._combined)))
        else:
            self._combined.pop(key)  # refresh recency
        self._combined[key] = step
        return step

    def _fit_capacity(self, template, names, n):
        """Free-allocatable copy counts for ``template`` aligned with the
        prepared rows: the fit layer's capacity floor for the gang solver.
        Returns None when no tracked node reports allocatable (everything
        unbounded), so callers skip the min and capacity-free paths stay
        byte-identical."""
        from ..fit.tracker import UNBOUNDED, pod_fit_request

        tracker = self._fit
        tracker.refresh()
        # one names-list object per (names, n), so the tracker's
        # identity-keyed row gather hits across cycles
        cached = self._fit_names
        if cached is None or cached[0] is not names or cached[1] != n:
            cached = self._fit_names = (names, n, list(names[:n]))
        rows = tracker.free_copy_counts(cached[2], pod_fit_request(template))
        if not (rows < UNBOUNDED).any():
            return None
        return rows

    def _numa_vectors(self, template, topology, topology_weight: int, names, n):
        """Per-node combined-score offsets and copy capacity for a burst of
        ``template`` clones, with the TopologyMatch plugin's own request and
        wrapper semantics (ref: filter.go:45-123, scorer.go:11-29):

        - nodes the plugin would skip (no guaranteed-CPU containers,
          non-Static CPUManagerPolicy) get offset 0 and unbounded capacity,
          the plugin's no-op score 0;
        - a missing NRT CR is Unschedulable: capacity 0;
        - aware bursts: offset ``weight * 100`` where a zone fits (the
          single assigned zone), else capacity 0 (ERR_NUMA_INSUFFICIENT);
        - non-aware: offset ``weight * (100 // greedy zones used)``,
          capacity from the pooled copies bound (``topology.batched``).

        Cached on the inputs the vectors derive from: the CR set (lister
        version), the store's row layout, ``n``, the weight and the request
        class; a hit also needs the plugin's identity (a weakref, which
        defeats ``id()`` recycling) and the assume cache's
        ``shrink_version``. Bound-pod churn is incremental: the cluster's
        pod-change journal names the nodes whose accounting moved, and only
        their rows are re-derived. Assume-cache removals carry no node and a
        journal overrun leaves the interval uncovered: both rebuild in
        full."""
        lister_version = getattr(topology.lister, "version", None)
        pod_version = self.cluster.pod_version
        shrink = topology.cache.shrink_version
        cache_key = None
        if lister_version is not None:
            cache_key = (id(topology), lister_version, self.store.layout_version, n,
                         topology_weight, self._class_key(template, topology))
            hit = self._numa_cache.get(cache_key)
            if hit is not None and hit["ref"]() is topology and hit["shrink"] == shrink:
                if hit["pod_version"] == pod_version:
                    return hit["offsets"].copy(), hit["capacity"].copy()
                changed = self.cluster.pod_changes_since(hit["pod_version"])
                if changed is not None:
                    self._numa_rows_update(template, topology, topology_weight, hit,
                                           changed, names, n)
                    hit["pod_version"] = pod_version
                    return hit["offsets"].copy(), hit["capacity"].copy()

        offsets, capacity = self._numa_vectors_uncached(template, topology, topology_weight,
                                                        names, n)
        if cache_key is not None:
            while len(self._numa_cache) >= 8:
                self._numa_cache.pop(next(iter(self._numa_cache)))
            self._numa_cache[cache_key] = {
                "ref": weakref.ref(topology),
                "offsets": offsets.copy(),
                "capacity": capacity.copy(),
                "pod_version": pod_version,
                "shrink": shrink,
                "row_of": None,  # built on the first incremental pass
            }
        return offsets, capacity

    def _numa_rows_update(self, template, topology, topology_weight, hit, changed, names,
                          n) -> None:
        """Re-derive the cached vectors' rows of the ``changed`` node names
        in place, through the one row derivation the full build runs
        (``_numa_derive_rows``): a row depends only on its own node's CR,
        bound pods and assumed entries, so this equals a rebuild."""
        self.numa_incremental_rows += len(changed)
        row_of = hit["row_of"]
        if row_of is None:
            row_of = hit["row_of"] = {name: i for i, name in enumerate(names[:n])}
        rows = [(row_of[name], name) for name in changed if name in row_of]
        if rows:
            self._numa_derive_rows(template, topology, topology_weight, rows,
                                   self.cluster.list_pods, hit["offsets"], hit["capacity"])

    def _numa_derive_rows(self, template, topology, topology_weight, rows, pods_for,
                          offsets, capacity, node_for=None) -> None:
        """The per-row NUMA derivation that full builds and incremental
        updates both run: write each ``(row, node name)``'s combined-score
        offset and copy capacity into the given arrays. ``pods_for(name)``
        gives the node's bound pods; ``node_for`` defaults to per-row
        cluster lookups (full builds pass a one-pass index). The batched
        zone evaluation and copy capacity run on this scheduler's device;
        ``copies_capacity`` is looked up on ``topology.batched`` at call
        time."""
        from ..topology import batched as topo_batched
        from ..topology.types import CPU_MANAGER_POLICY_STATIC

        state = CycleState()
        topology.pre_filter(state, template)
        s = topology._get_state(state)
        if s is None or template.is_daemonset_pod() or not s.target_container_indices:
            # the plugin no-ops for this pod class: default vectors
            for i, _ in rows:
                offsets[i] = 0
                capacity[i] = 1 << 30
            return
        enforced: list = []
        if node_for is None:
            node_for = self.cluster.get_node
        for i, name in rows:
            offsets[i] = 0
            capacity[i] = 1 << 30
            node = node_for(name)
            if node is None:
                capacity[i] = 0
                continue
            try:
                nrt = topology.lister.get(name)
            except KeyError:
                capacity[i] = 0  # ref: filter.go:56-58 Unschedulable
                continue
            if nrt.crane_manager_policy.cpu_manager_policy != CPU_MANAGER_POLICY_STATIC:
                continue  # kubelet handles cpuset: the plugin no-ops
            nw = topology._initialize_node_wrapper(
                s, NodeInfo(node=node, pods=pods_for(name)), nrt
            )
            enforced.append((i, nw))
        if not enforced:
            return
        request = s.target_container_resource
        idx = [i for i, _ in enforced]
        wrappers = [nw for _, nw in enforced]
        aware_mask = np.array([nw.aware for nw in wrappers], dtype=bool)
        ev = topo_batched.evaluate_topology_batch(wrappers, request, device=self.device)
        caps = topo_batched.copies_capacity(wrappers, request, aware=aware_mask,
                                            device=self.device).astype(np.int64)
        caps = np.where(aware_mask & ~ev.aware_fits, 0, caps)
        # aware pods take one whole zone: plugin score 100 (ref: helper.go
        # :276-284, a single-zone result); non-aware: 100 // zones used
        offs = np.where(aware_mask, 100 * int(topology_weight),
                        ev.scores.astype(np.int64) * int(topology_weight))
        offsets[idx] = offs.astype(np.int32)
        capacity[idx] = caps

    def _numa_vectors_uncached(self, template, topology, topology_weight, names, n):
        """Full build: the shared row derivation over every row, with the
        bound-pod index built in one ``list_pods`` pass (per-row lookups
        would take the cluster lock N times)."""
        offsets = np.zeros((n,), dtype=np.int32)
        capacity = np.full((n,), 1 << 30, dtype=np.int64)
        pods_by_node: dict[str, list] = {}
        for pod in self.cluster.list_pods():
            if pod.node_name:
                pods_by_node.setdefault(pod.node_name, []).append(pod)
        nodes_by_name = {node.name: node for node in self.cluster.list_nodes()}
        self._numa_derive_rows(template, topology, topology_weight,
                               list(enumerate(names[:n])),
                               lambda name: pods_by_node.get(name, []),
                               offsets, capacity, node_for=nodes_by_name.get)
        return offsets, capacity

    def schedule_gang(
        self,
        template,
        count: int,
        topology=None,
        bind: bool = True,
        dynamic_weight: int = 3,
        topology_weight: int = 2,
    ) -> BatchResult:
        """Burst-schedule ``count`` identical copies of ``template`` with
        combined plugin scoring (Dynamic x3 and, with NUMA,
        NodeResourceTopologyMatch x2: the deploy-config weights), capped
        per node by the free-allocatable copy counts and, with
        ``topology``, by the NUMA copy capacity. The water-filling solve
        runs in the weighted-sum score domain. With ``bind=True`` each
        assigned copy is created in the cluster and driven through the
        topology plugin's Filter -> Reserve -> PreBind, so zone results land
        on pod annotations and later cycles see the NUMA usage; copies the
        plugin rejects re-solve with corrected capacity."""
        now = self._clock()
        self.refresh()
        prepared = self._prepare(now)
        n = self._prepared_n
        names = self._prepared_names

        step = self._combined_step(dynamic_weight, topology_weight)
        fit_rows = self._fit_capacity(template, names, n)
        npad = prepared.rows()
        if topology is not None:
            offsets, capacity = self._numa_vectors(template, topology, topology_weight,
                                                   names, n)
            if fit_rows is not None:
                np.minimum(capacity, fit_rows, out=capacity)
            prepared = step.with_vectors(prepared, np.pad(capacity, (0, npad - n)),
                                         np.pad(offsets, (0, npad - n)))
        elif fit_rows is not None:
            # allocatable is reported: the fit rows alone cap the solver
            prepared = step.with_vectors(prepared, np.pad(fit_rows, (0, npad - n)),
                                         np.zeros((npad,), dtype=np.int32))

        packed = step.packed(prepared, count, now=now).result()
        keys = [f"{template.namespace}/{template.name}-{i}" for i in range(count)]
        result = self._build_result(packed, keys, now=now)
        if bind:
            result = self._bind_gang_with_recovery(template, result, topology, now,
                                                   dynamic_weight, topology_weight)
        return result

    def _bind_assignments_sequential(self, pods_for, assignments, topology, now):
        """The reference-shaped per-pod bind loop: the topology plugin's
        Filter -> Reserve -> PreBind per pod, then the bind (ref:
        reserver.go, binder.go). The semantic twin ``_bind_assignments`` is
        tested against; same contract."""
        get_node = self.cluster.get_node
        bound: dict[str, str] = {}
        rejected: list[str] = []
        rejecting: set[str] = set()
        dropped: list[str] = []
        for pod_key, node_name in assignments.items():
            pod, create = pods_for(pod_key)
            if pod is None:
                dropped.append(pod_key)
                continue
            node = get_node(node_name) if topology is not None else None
            if node is not None:
                state = CycleState()
                topology.pre_filter(state, pod)
                node_info = NodeInfo(node=node, pods=self.cluster.list_pods(node_name))
                if not topology.filter(state, pod, node_info).ok():
                    rejected.append(pod_key)
                    rejecting.add(node_name)
                    continue
                if create:
                    self.cluster.add_pod(pod)
                if topology.reserve(state, pod, node_name).ok():
                    topology.pre_bind(state, pod, node_name)
            elif create:
                self.cluster.add_pod(pod)
            if not self.cluster.bind_pod(pod_key, node_name, now):
                dropped.append(pod_key)
                continue
            bound[pod_key] = node_name
        return bound, rejected, rejecting, dropped

    def _bind_assignments(self, pods_for, assignments, topology, now: float):
        """Shared bind application for gang copies and pending pods,
        grouped by node: the plugin evaluates its Filter gates once per node
        group (``TopologyMatch.group_context``) and assigns each accepted
        copy against the group's evolving wrapper (``group_assign``) — the
        accounting a per-pod wrapper rebuild would derive from the previous
        copies' result annotations, since in-gang usage is monotone and
        wrapper state is per node. All copies of one ``_bind_recover_loop``
        pass share a scheduling class (``_class_key``). Each node group
        creates its pods (``add_pods``) and binds them in one ``bind_pods``
        transaction (event multiset and pod-version moves identical to
        per-pod binds).

        Equal to the sequential twin (``_bind_assignments_sequential``) in
        placements, rejections, zone-result annotations, assume-cache
        contents and counts, with one deliberate divergence: a copy whose
        bind fails has already been charged to its node's NUMA usage for
        later copies of the same group (the conservative direction: never
        over-admits).

        ``pods_for(key) -> (pod | None, create)`` resolves each key;
        ``create`` means the pod must be added to the cluster first (the
        gang path creates copies from a template). Returns ``(bound,
        rejected, rejecting, dropped)``: ``rejected`` keys were
        Filter-rejected on their node (the nodes in ``rejecting``) and can
        re-solve elsewhere; ``dropped`` keys cannot bind and go straight to
        unassigned."""
        from ..topology.types import ANNOTATION_POD_TOPOLOGY_RESULT, zones_to_json

        get_node = self.cluster.get_node
        bound: dict[str, str] = {}
        rejected: list[str] = []
        rejecting: set[str] = set()
        dropped: list[str] = []
        by_node: dict[str, list[str]] = {}
        for pod_key, node_name in assignments.items():
            by_node.setdefault(node_name, []).append(pod_key)

        for node_name, keys in by_node.items():
            resolved = [(key, *pods_for(key)) for key in keys]
            ctx = None
            if topology is not None:
                node = get_node(node_name)
                template = next((pod for _, pod, _ in resolved if pod is not None), None)
                if node is not None and template is not None:
                    ctx = topology.group_context(template, node,
                                                 self.cluster.list_pods(node_name))
            if ctx == "missing_nrt":  # the whole group is Unschedulable
                for key, pod, _ in resolved:
                    if pod is None:
                        dropped.append(key)
                    else:
                        rejected.append(key)
                        rejecting.add(node_name)
                continue

            to_create: list = []
            to_bind: list[tuple[str, str]] = []
            assumed: list = []
            for pod_key, pod, create in resolved:
                if pod is None:
                    dropped.append(pod_key)
                    continue
                if ctx is not None:
                    result = topology.group_assign(ctx)
                    if result is None:
                        rejected.append(pod_key)
                        rejecting.add(node_name)
                        continue
                    if result:
                        # Reserve (assume) and PreBind's annotation; created
                        # copies carry the annotation from birth
                        raw = zones_to_json(result)
                        if create:
                            anno = dict(pod.annotations)
                            anno[ANNOTATION_POD_TOPOLOGY_RESULT] = raw
                            pod = replace(pod, annotations=anno)
                        assumed.append((pod, result, raw, create))
                if create:
                    to_create.append(pod)
                to_bind.append((pod_key, node_name))

            for pod, result, raw, create in assumed:
                try:
                    topology.cache.assume_pod(pod, result)
                except KeyError:
                    continue  # double-assume: Reserve would have errored
                if not create:
                    self.cluster.patch_pod_annotation(pod.key(), ANNOTATION_POD_TOPOLOGY_RESULT,
                                                      raw)
            if to_create:
                self.cluster.add_pods(to_create)
            bound_keys = set(self.cluster.bind_pods(to_bind, now))
            for pod_key, node in to_bind:
                if pod_key in bound_keys:
                    bound[pod_key] = node
                else:
                    dropped.append(pod_key)
        return bound, rejected, rejecting, dropped

    def _bind_gang(self, template, assignments, topology, now: float):
        """Create and bind each assigned copy of ``template``."""

        def pods_for(pod_key):
            return (
                replace(template, name=pod_key.split("/", 1)[1],
                        annotations=dict(template.annotations), node_name=""),
                True,
            )

        return self._bind_assignments(pods_for, assignments, topology, now)

    def _bind_gang_with_recovery(self, template, result: BatchResult, topology, now: float,
                                 dynamic_weight: int, topology_weight: int) -> BatchResult:
        """Bind the gang; when the plugin's Filter rejects over-admitted
        copies (the copies-capacity estimate admitted more than truly fit),
        re-run the waterline for just the rejected copies with corrected
        capacity (``_bind_recover_loop``). Copies that still find no home
        end up unassigned, never bound zone-less."""
        n = self._prepared_n
        scores = schedulable = None  # read only by a re-solve: none without the plugin
        if topology is not None:
            scores = np.fromiter(result.scores.values(), np.int64, count=n)
            schedulable = np.fromiter(result.schedulable.values(), bool, count=n)
        prior = np.zeros((n,), np.int64)
        assignments, unplaced = self._bind_recover_loop(
            lambda a: self._bind_gang(template, a, topology, now), result.assignments,
            template, topology, scores, schedulable, prior, dynamic_weight, topology_weight,
        )
        return BatchResult(
            assignments=assignments,
            unassigned=list(result.unassigned) + unplaced,
            scores=result.scores,
            schedulable=result.schedulable,
            now=result.now,
        )

    def _bind_recover_loop(self, bind_fn, assignments, template, topology, scores,
                           schedulable, prior, dynamic_weight: int, topology_weight: int):
        """Run ``bind_fn`` (the ``_bind_assignments`` contract), re-solving
        rejected pods with corrected capacity up to ``_RECOVER_PASSES`` times:
        rejecting nodes drop to zero capacity (copies are identical: a node
        that rejected one rejects all at its current state), the other
        nodes' capacity is re-derived from the updated NUMA usage, and the
        hot-penalty staircase continues past the pods already bound
        (``prior``). Dropped keys go straight to unplaced. ``prior`` is
        updated in place with every bind, so a caller chaining several
        classes through one cycle keeps the staircase continuous. Returns
        ``(bound: {key: node}, unplaced: [key])``."""
        n = self._prepared_n
        names = self._prepared_names
        idx = {name: i for i, name in enumerate(names[:n])}
        bound_all: dict[str, str] = {}
        unplaced: list[str] = []
        banned: set[str] = set()

        bound, rejected, rejecting, dropped = bind_fn(assignments)
        unplaced.extend(dropped)
        for node_name in bound.values():
            prior[idx[node_name]] += 1
        bound_all.update(bound)
        for _ in range(_RECOVER_PASSES):
            if not rejected:
                break
            banned |= rejecting
            offsets, capacity = self._numa_vectors(template, topology, topology_weight,
                                                   names, n)
            fit_rows = self._fit_capacity(template, names, n)
            if fit_rows is not None:
                np.minimum(capacity, fit_rows, out=capacity)
            for node_name in banned:
                capacity[idx[node_name]] = 0
            retry = gang_assign_host(
                scores, schedulable, len(rejected), self.tensors.hv_count,
                capacity=capacity, offsets=offsets, dynamic_weight=dynamic_weight,
                max_offset=MAX_NODE_SCORE * topology_weight, prior=prior,
            )
            new_assign, leftover = self._expand_counts(scores, retry.counts, names, rejected)
            unplaced.extend(leftover)
            if not new_assign:
                rejected = []
                break
            bound, rejected, rejecting, dropped = bind_fn(new_assign)
            unplaced.extend(dropped)
            for key, node_name in bound.items():
                bound_all[key] = node_name
                prior[idx[node_name]] += 1
        unplaced.extend(rejected)  # passes exhausted
        return bound_all, unplaced

    def _ensure_gang(self, dynamic_weight, topology_weight, accel_label):
        """The lazily built gang engine: version-cached gang columns
        (``framework.drip.GangColumns``) and the K-gang window
        (``scorer.gang_batch.GangBatchKernel``), keyed on the weight pair
        and accelerator label so a caller cycling configurations rebuilds
        instead of mixing column epochs across windows."""
        from ..scorer.gang_batch import GangBatchKernel
        from .drip import GangColumns

        key = (int(dynamic_weight), int(topology_weight), accel_label)
        eng = self._gang_engine
        if eng is not None and eng["key"] == key:
            return eng
        cols = GangColumns(
            self.cluster,
            dyn_weight=int(dynamic_weight),
            order=("dyn", "fit"),
            fit_tracker=self._fit,
            telemetry=self._telemetry,
            policy=self.policy,
            accel_label=accel_label,
        )
        kern = GangBatchKernel(
            self.tensors.hv_count,
            dynamic_weight=int(dynamic_weight),
            max_offset=MAX_NODE_SCORE * int(topology_weight),
            device=self.device,
        )
        eng = {
            "key": key,
            "cols": cols,
            "kern": kern,
            "argsort": None,  # (id(score), col_epoch, by_score)
            "offs_cache": {},  # sorted tput items -> (accel_epoch, row)
            "zeros_offs": None,  # shared all-zero offset row, length n
        }
        self._gang_engine = eng
        return eng

    def _gang_offsets(self, eng, template, throughput, topology_weight):
        """Per-node combined-score offset row for ``template``'s
        per-accelerator-type throughput weights (a template that runs
        faster on one accelerator family bids its nodes up by the weight).
        None when the queue carries no weights for this template: the
        homogeneous default, identical to the zero-offset path. Rows are
        cached per weight map on the accel column epoch, so repeated gangs
        of one template reuse one array and the device column cache never
        re-uploads it."""
        if not throughput:
            return None
        tput = throughput.get(template.name)
        if tput is None:
            tput = throughput.get(f"{template.namespace}/{template.name}")
        if not tput:
            return None
        cols = eng["cols"]
        accel = cols.ensure_accel()
        key = tuple(sorted(tput.items()))
        hit = eng["offs_cache"].get(key)
        if hit is not None and hit[0] == cols.accel_epoch:
            return hit[1]
        row = np.zeros((len(cols.names),), dtype=np.int32)
        for label, w in tput.items():
            if not w:
                continue
            tid = cols._accel_index.get(label)
            if tid is not None:
                row[accel == tid] = int(w)
        np.clip(row, 0, MAX_NODE_SCORE * int(topology_weight), out=row)
        cache = eng["offs_cache"]
        while len(cache) >= 16:
            cache.pop(next(iter(cache)))
        cache[key] = (cols.accel_epoch, row)
        return row

    def schedule_gang_queue(
        self,
        requests,
        topology=None,
        bind: bool = True,
        window: int = 8,
        dynamic_weight: int = 3,
        topology_weight: int = 2,
        throughput=None,
        accel_label: str | None = None,
        tie_policy=None,
        tie_rng=None,
    ) -> list[GangOutcome]:
        """Schedule a queue of heterogeneous gangs — ``requests`` is an
        ordered iterable of ``(template, count)`` pairs — through the
        batched window: up to ``window`` gangs solve in one device window
        against the version-cached gang columns, with a capacity fold so
        later gangs see earlier gangs' consumption, and one device-to-host
        copy per window. No ``refresh()``/``_prepare`` per gang: a named
        annotation patch between gangs re-reads only the journal's dirty
        rows. Placements equal a sequential ``schedule_gang(bind=...)``
        loop over the same requests.

        - ``throughput``: optional ``{template name (or "ns/name"): {accel
          label value: weight}}`` per-accelerator-type score offsets; nodes
          are classed by ``labels[accel_label]``.
        - ``tie_policy``: None (node-order prefix split),
          ``"fragmentation"`` or ``"seeded"`` (with ``tie_rng``); the
          non-default policies solve on the host (``gang_window_host``).
        - gangs needing NUMA vectors (``topology`` given) or carrying
          scalar (extended) resources fall back to ``schedule_gang`` one by
          one, the open window flushed first so queue order, and with it
          capacity evolution, is kept.
        """
        from ..fit.tracker import pod_fit_request

        eng = self._ensure_gang(dynamic_weight, topology_weight, accel_label)
        outcomes: list[GangOutcome] = []
        buf: list[tuple] = []  # (template, count)

        def flush():
            if buf:
                self._flush_gang_window(eng, buf, outcomes, bind, dynamic_weight,
                                        topology_weight, throughput, tie_policy, tie_rng)
                buf.clear()

        for template, count in requests:
            if topology is not None or pod_fit_request(template).scalar_resources:
                flush()  # keep queue order and capacity evolution
                r = self.schedule_gang(template, int(count), topology=topology, bind=bind,
                                       dynamic_weight=dynamic_weight,
                                       topology_weight=topology_weight)
                outcomes.append(GangOutcome(
                    assignments=dict(r.assignments), unassigned=list(r.unassigned),
                    waterline=None, now=r.now, source="fallback",
                ))
                self._gang["fallbacks"] += 1
                # the fallback bound pods behind the columns' back: force a
                # fit rebuild and a carry upload next window
                eng["cols"].drop_fit()
                eng["kern"].mark_desynced()
                continue
            buf.append((template, int(count)))
            if len(buf) >= int(window):
                flush()
        flush()
        return outcomes

    def _flush_gang_window(self, eng, buf, outcomes, bind, dynamic_weight, topology_weight,
                           throughput, tie_policy, tie_rng) -> None:
        """Solve and (optionally) bind one buffered window of gangs; one
        ``GangOutcome`` per buffered request is appended in order."""
        from ..fit.tracker import pod_fit_request, request_vec
        from ..scorer.gang_batch import gang_window_host

        cols = eng["cols"]
        kern = eng["kern"]
        total = sum(c for _, c in buf)
        now = self._clock()
        with maybe_span(self._telemetry, "gang_dispatch", gangs=len(buf), pods=total):
            cols.ensure(now)
            names = cols.names
            n = len(names)
            if n == 0:
                for t, c in buf:
                    keys = [f"{t.namespace}/{t.name}-{i}" for i in range(c)]
                    outcomes.append(GangOutcome({}, keys, -1, now, "window"))
                return
            score = cols.score
            sched = cols.schedulable
            bounded = cols.bounded
            free = cols.free

            # dedupe request classes across the window: the device window
            # takes a [C, 4] class matrix and per-gang class ids. Offset
            # rows derive here, after ensure(), so they align with the
            # current membership by construction
            class_of: dict = {}
            vecs: list = []
            offs_rows: list = []
            gang_vecs: list = []
            class_id = np.empty((len(buf),), np.int32)
            pods = np.empty((len(buf),), np.int64)
            for j, (t, c) in enumerate(buf):
                offs = self._gang_offsets(eng, t, throughput, topology_weight)
                vec = request_vec(pod_fit_request(t))
                ck = (vec.tobytes(), id(offs))
                cid = class_of.get(ck)
                if cid is None:
                    cid = class_of[ck] = len(vecs)
                    vecs.append(vec)
                    offs_rows.append(offs)
                class_id[j] = cid
                pods[j] = c
                gang_vecs.append(vec)

            # the fold fence, captured before any bind moves pod_version
            cluster_pre = self.cluster.pod_version
            t0 = time.perf_counter()
            if bind and tie_policy is None:
                dispatch_offs = None
                if any(o is not None for o in offs_rows):
                    zeros = eng["zeros_offs"]
                    if zeros is None or zeros.shape[0] != n:
                        zeros = eng["zeros_offs"] = np.zeros((n,), np.int32)
                    dispatch_offs = [zeros if o is None else o for o in offs_rows]
                counts_m, _unassigned, wl_v = kern.dispatch(
                    score, sched, bounded, free, np.stack(vecs).astype(np.int64),
                    dispatch_offs, class_id, pods,
                    col_version=cols.col_epoch, col_delta=cols.dirty_rows_between,
                )
            else:
                # the host window: tie policies reorder the waterline take,
                # which the prefix split cannot express; and bind=False
                # must not fold (sequential bind=False calls see no
                # capacity evolution either)
                host_res, _free_after = gang_window_host(
                    score, sched, bounded, free,
                    [(int(pods[j]), gang_vecs[j], offs_rows[int(class_id[j])])
                     for j in range(len(buf))],
                    self.tensors.hv_count,
                    dynamic_weight=int(dynamic_weight),
                    max_offset=MAX_NODE_SCORE * int(topology_weight),
                    tie_policy=tie_policy, tie_rng=tie_rng, fold=bind,
                )
                counts_m = np.stack([np.asarray(r.counts, np.int64) for r in host_res])
                wl_v = np.array([r.waterline for r in host_res])
            solve_seconds = time.perf_counter() - t0

            # score-descending expansion order, cached per column epoch
            # (the O(n log n) stable argsort is shared by every gang and
            # window until a patch moves a score)
            by = eng["argsort"]
            if by is None or by[0] != id(score) or by[1] != cols.col_epoch:
                by = eng["argsort"] = (id(score), cols.col_epoch,
                                       np.argsort(-score, kind="stable"))
            by_score = by[2]

            n_bound = 0
            fold_plan: list = []
            for j, (t, c) in enumerate(buf):
                counts_j = np.asarray(counts_m[j])
                order = np.repeat(by_score, counts_j[by_score])
                keys = [f"{t.namespace}/{t.name}-{i}" for i in range(c)]
                assignments = {key: names[int(i)] for key, i in zip(keys, order)}
                unassigned_keys = list(keys[len(order):])
                if bind:
                    bound, _rej, _rejing, dropped = self._bind_gang(t, assignments, None, now)
                    unassigned_keys.extend(dropped)
                    n_bound += len(bound)
                    assignments = bound
                    fold_plan.append((counts_j, gang_vecs[j]))
                outcomes.append(GangOutcome(
                    assignments=assignments, unassigned=unassigned_keys,
                    waterline=int(wl_v[j]), now=now, source="window",
                ))

            if bind:
                # fold fence: replay the window's folds into the host free
                # column only when our binds are the only pod writes and
                # every counted pod bound — anything else (an interleaved
                # writer, a dropped bind) invalidates the carry
                ok = (
                    free is not None
                    and cols._fit_pod_ver == cluster_pre
                    and self.cluster.pod_version == cluster_pre + n_bound
                    and n_bound == int(counts_m.sum())
                )
                if ok:
                    for counts_j, vec in fold_plan:
                        for i in np.flatnonzero(counts_j):
                            cols.fold_row(int(i), int(counts_j[i]) * vec)
                    cols.commit_folds(cluster_pre + n_bound)
                    kern.mark_synced(cols.free)
                else:
                    cols.drop_fit()
                    kern.mark_desynced()

        g = self._gang
        g["windows"] += 1
        g["gangs"] += len(buf)
        g["pods"] += total
        g["window_sizes"].append(len(buf))
        g["kernel_seconds"].append(solve_seconds)
        if len(g["window_sizes"]) > 256:
            del g["window_sizes"][:-256]
            del g["kernel_seconds"][:-256]
        if self._m_gang_pods is not None:
            self._m_gang_pods.observe(total)
            self._m_gang_kernel.observe(solve_seconds)

    def gang_stats(self) -> dict:
        """Dispatch-window counters, the gang twin of ``drip_stats``."""
        g = self._gang
        out = {
            "windows": g["windows"],
            "gangs": g["gangs"],
            "pods": g["pods"],
            "fallbacks": g["fallbacks"],
            "window_sizes": list(g["window_sizes"]),
            "kernel_seconds": list(g["kernel_seconds"]),
        }
        eng = self._gang_engine
        if eng is not None:
            out["columns"] = dict(eng["cols"].stats)
            out["kernel_dispatches"] = eng["kern"].dispatches
            out["free_uploads"] = eng["kern"].free_uploads
        return out

    # -- heterogeneous (mixed) batches -------------------------------------

    def _bind_existing(self, pods_by_key, assignments, topology, now: float):
        """Bind already-pending pods (the mixed-batch path); same contract
        as ``_bind_gang``."""
        return self._bind_assignments(
            lambda key: (pods_by_key.get(key), False), assignments, topology, now
        )

    def _class_key(self, pod, topology):
        """Scheduling-equivalence class for one cycle: the Dynamic score is
        pod-independent, so pods differ only in how TopologyMatch treats
        them — daemonset-ness (Filter bypass, plugin no-op; ref:
        plugins.go:41-43, filter.go:60-62), topology awareness, and the
        guaranteed-CPU request the plugin packs (ref: filter.go:20-37)."""
        is_ds = bool(pod.is_daemonset_pod())
        if topology is None:
            return ("plain", is_ds)
        state = CycleState()
        topology.pre_filter(state, pod)
        s = topology._get_state(state)
        if is_ds or s is None or not s.target_container_indices:
            return ("noop", is_ds)
        r = s.target_container_resource
        return (
            "numa",
            s.aware,
            r.milli_cpu,
            r.memory,
            r.ephemeral_storage,
            r.allowed_pod_number,
            # scalar (device or extended) resources feed the NUMA fit check:
            # templates differing only here must not alias
            tuple(sorted(r.scalar_resources.items())),
        )

    def schedule_batch_mixed(
        self,
        pods: list[Pod],
        topology=None,
        bind: bool = True,
        dynamic_weight: int = 3,
        topology_weight: int = 2,
    ) -> BatchResult:
        """Heterogeneous burst: group pending pods by scheduling-
        equivalence class and water-fill class by class against shared
        evolving capacity. Classes run in first-appearance order, each
        with the same water-filling as ``schedule_gang`` (on the host, from
        the cycle's one device fetch), and the hot-penalty staircase
        continues across classes (``prior``). DaemonSet pods bypass Filter
        and form an always-schedulable class.

        With ``topology``, classes also split on NUMA awareness and the
        guaranteed-CPU request, and a NUMA class solves with the NUMA
        vectors. NUMA capacity consumed by earlier classes reaches later
        ones through bound pods' zone annotations, so cross-class capacity
        evolution needs ``bind=True``; ``bind=False`` previews each class
        against the pre-batch NUMA state. Filter-rejected over-admissions
        recover per class through the corrected-capacity re-solve."""
        from ..fit.tracker import UNBOUNDED

        now = self._clock()
        self.refresh()
        prepared = self._prepare(now)
        n = self._prepared_n
        names = self._prepared_names
        idx = {name: i for i, name in enumerate(names[:n])}

        # one packed fetch for the cycle's shared verdicts (hybrid rescue
        # rows included, so the class solves on the host stay exact)
        packed = self._step.packed(prepared, 0, now=now).result()
        schedulable, scores, _counts, _un, _ = ScheduleStep.unpack(packed, n)
        scores = np.asarray(scores, np.int64)
        sched = np.asarray(schedulable, bool)

        classes: dict = {}
        for pod in pods:
            classes.setdefault(self._class_key(pod, topology), []).append(pod)

        prior = np.zeros((n,), np.int64)
        assignments: dict[str, str] = {}
        unassigned: list[str] = []
        for key, members in classes.items():
            template = members[0]
            # DaemonSet pods always pass Filter (ref: plugins.go:41-43)
            cls_sched = np.ones((n,), bool) if template.is_daemonset_pod() else sched
            if key[0] == "numa":
                offsets, capacity = self._numa_vectors(template, topology, topology_weight,
                                                       names, n)
            else:
                offsets = np.zeros((n,), np.int32)
                capacity = np.full((n,), UNBOUNDED, np.int64)
            fit_rows = self._fit_capacity(template, names, n)
            if fit_rows is not None:
                np.minimum(capacity, fit_rows, out=capacity)
            solved = gang_assign_host(
                scores, cls_sched, len(members), self.tensors.hv_count,
                capacity=capacity, offsets=offsets,
                dynamic_weight=dynamic_weight,
                max_offset=MAX_NODE_SCORE * topology_weight, prior=prior,
            )
            keys_c = [p.key() for p in members]
            assign_c, un_c = self._expand_counts(scores, solved.counts, names, keys_c)
            unassigned.extend(un_c)
            if bind:
                pods_by_key = {p.key(): p for p in members}
                bound, unplaced = self._bind_recover_loop(
                    lambda a, pbk=pods_by_key: self._bind_existing(pbk, a, topology, now),
                    assign_c, template, topology, scores, cls_sched, prior,
                    dynamic_weight, topology_weight,
                )
                assignments.update(bound)
                unassigned.extend(unplaced)
            else:
                assignments.update(assign_c)
                for node_name in assign_c.values():
                    prior[idx[node_name]] += 1
        return BatchResult(
            assignments=assignments,
            unassigned=unassigned,
            scores={names[i]: int(scores[i]) for i in range(n)},
            schedulable={names[i]: bool(sched[i]) for i in range(n)},
            now=now,
        )


# -- the per-pod (drip) path ---------------------------------------------------


class ScheduleResult:
    """One drip placement outcome. ``scores`` materializes lazily: the
    columnar path hands over closures instead of building a 50k-entry dict
    per pod nobody may read — reading ``.scores`` (or asking for
    ``top_scores``) pays the cost only on demand."""

    __slots__ = (
        "pod_key", "node", "feasible", "reason",
        "_scores", "_lazy_scores", "_lazy_topk", "_reasons_fn",
    )

    def __init__(self, pod_key: str, node: str | None, feasible: int, reason: str = "",
                 scores: dict | None = None, lazy_scores=None, lazy_topk=None):
        self.pod_key = pod_key
        self.node = node
        self.feasible = feasible
        self.reason = reason
        self._scores = scores
        self._lazy_scores = lazy_scores
        self._lazy_topk = lazy_topk
        self._reasons_fn = None  # lazy filter-reason histogram (columnar)

    @property
    def scores(self) -> dict:
        if self._scores is None:
            lazy = self._lazy_scores
            self._scores = {} if lazy is None else lazy()
        return self._scores

    def top_scores(self, k: int = 5) -> list:
        """Top-k ``(node, score)`` pairs, highest score first, name
        ascending among ties — the order of ``sorted(scores.items(),
        key=(-score, name))[:k]`` without the full sort, and without
        materializing the score dict on the columnar path."""
        import heapq

        if self._scores is None and self._lazy_topk is not None:
            return self._lazy_topk(k)
        return heapq.nsmallest(k, self.scores.items(), key=lambda kv: (-kv[1], kv[0]))

    def filter_reasons(self) -> dict:
        """Filter-failure histogram over the infeasible nodes (columnar
        results; empty for the scalar loop's)."""
        return {} if self._reasons_fn is None else self._reasons_fn()

    def __repr__(self) -> str:
        return (
            f"ScheduleResult(pod_key={self.pod_key!r}, node={self.node!r}, "
            f"feasible={self.feasible}, reason={self.reason!r})"
        )


@dataclass
class _WeightedPlugin:
    plugin: object
    weight: int = 1


class _Hooks:
    """Per-registration resolution of the plugin extension points, so the
    scalar loop pays no ``getattr`` per plugin per node. Rebuilt whenever
    ``register`` changes the plugin list."""

    __slots__ = ("pre_filter", "filter", "score", "reserve", "pre_bind", "unreserve")

    def __init__(self, plugins: list[_WeightedPlugin]):
        def hooks(name):
            return [h for wp in plugins if (h := getattr(wp.plugin, name, None)) is not None]

        self.pre_filter = hooks("pre_filter")
        self.filter = hooks("filter")
        self.score = [
            (h, wp.weight) for wp in plugins
            if (h := getattr(wp.plugin, "score", None)) is not None
        ]
        self.reserve = hooks("reserve")
        self.pre_bind = hooks("pre_bind")
        self.unreserve = hooks("unreserve")


@dataclass(frozen=True)
class _PluginSet:
    """A plugin set the columnar paths serve (``Scheduler._parse_plugins``):
    the ``DynamicPlugin`` and its weight, the ``ResourceFitPlugin``'s
    tracker (None without Fit), the registration order (``"dyn"``,
    ``"fit"``, ``"nrt"``) and ``topo``, the ``TopologyMatch`` and its
    weight (None without it), which makes a window the NRT window."""

    dyn: object
    dyn_weight: int
    tracker: object
    order: tuple
    topo: tuple | None


# the batched drip window's stages (Scheduler._dispatch_window); a window
# runs them in this order, with drip_zone (the NRT window's zone results,
# annotation writes and assumes) between drip_wait and drip_bind
DRIP_STAGES = ("drip_admit", "drip_prepare", "drip_launch", "drip_wait", "drip_bind",
               "drip_fold", "drip_zone")


class Scheduler:
    """Plugin-driven single-pod scheduler (the reference-shaped path).

    Counterpart of ``Scheduler`` in ``crane_scheduler_tpu/framework/
    scheduler.py``: the scalar plugin loop (``columnar=False``; the parity
    oracle and the fallback for daemonset pods, degraded mode, scalar
    extended-resource requests and unknown plugins), the columnar fast
    path over ``framework.drip.DripColumns``, and the batched windows of
    ``schedule_queue`` / ``open_queue`` through ``scorer.drip_batch``
    (with ``TopologyMatch`` registered too: the NRT window, the same
    ``_dispatch_window`` with a zone carry).
    Host selection takes the max weighted score, the lowest snapshot index
    among ties, or a seeded-random tie with ``tie_break_seed``.

    Not thread-safe: one Scheduler serves one scheduling loop (concurrent
    cluster writers are fine; the version fences detect their writes)."""

    def __init__(
        self,
        cluster: ClusterState,
        clock=time.time,
        telemetry=None,
        tie_break_seed: int | None = None,
        columnar: bool = True,
        mesh=None,
        device=None,
    ):
        """``tie_break_seed``: seeded-random choice among exactly tied
        hosts (the stock kube-scheduler's behaviour); default off = lowest
        snapshot index. ``columnar``: use the version-cached column fast
        path whenever the plugin set and the pod allow it; placements are
        identical to the scalar loop. ``device``: where the batched window
        runs; ``None`` means the GPU (raises without one), tests pass
        ``"cpu"``. ``telemetry``: a ``Telemetry`` bundle, else the
        process-global one (``telemetry.active()``), else none. ``mesh``: a
        placement mesh (``parallel.mesh.make_placement_mesh``): the batched
        window tiles its columns over it and runs the shard-parallel
        window, placements unchanged; without ``device`` its first tile's
        device is the scheduler's."""
        import random

        self.cluster = cluster
        self.device = _mesh_device(mesh, device)
        self._kernel_mesh = mesh
        self._clock = clock
        self._plugins: list[_WeightedPlugin] = []
        self._tie_rng = random.Random(tie_break_seed) if tie_break_seed is not None else None
        self._cache: tuple[int, list] | None = None  # (sched_version, snapshot)
        self._columnar = bool(columnar)
        self._hooks: _Hooks | None = None
        self._drip = None  # DripColumns once plugins are recognized
        # plugin recognition (_PluginSet) for the columnar path: False =
        # not yet computed, None = unrecognized set (scalar forever)
        self._recognized: _PluginSet | None | bool = False
        self._unrecognized_reason = "unknown_plugin"
        self._window_rec: _PluginSet | None | bool = False  # the same, for the window
        self._fallbacks: dict[str, int] = {}
        # bind-plane backpressure: an optional callable that blocks while
        # a downstream bind-flush queue is over its watermark, so window
        # admission pauses instead of queueing binds without bound
        self.bind_backpressure = None
        # the batched window (scorer.drip_batch), created at first use
        self._batch_kernel = None
        self._batch = {
            "dispatches": 0, "pods": 0, "replays": 0,
            "batch_sizes": [], "conflicts": 0,
            "zone_windows": 0, "zone_results": 0, "cross_zone_binds": 0,
        }
        # the NRT window's per-pod request and awareness, by container
        # tuple and the two annotations (the tuple kept alive beside its id)
        self._nrt_rows: dict = {}
        # optimistic multi-scheduler mode: re-check the pod_version fence
        # after the window and before the bind POSTs, dropping and
        # retrying the window when another binder moved it
        self.conflict_retry = False
        self.conflict_cb = None  # callable(outcome: str) | None
        self.max_window_retries = 4
        tel = self._telemetry = telemetry if telemetry is not None else active_telemetry()
        # the batched window's stages, always timed; with telemetry on each
        # is also a span (and, under profiler_ranges(), a profiler range)
        self._stages = StageClock(DRIP_STAGES, tel.spans if tel is not None else None)
        self._m_decisions = self._m_fallback = self._m_batch_pods = self._m_kernel_s = None
        if tel is not None:
            reg = tel.registry
            self._m_decisions = reg.counter(
                "crane_drip_decisions_total", "schedule_one outcomes", ("outcome",),
            )
            self._m_fallback = reg.counter(
                "crane_drip_fallback_total",
                "schedule_one calls that took the scalar fallback", ("reason",),
            )
            self._m_batch_pods = reg.histogram(
                "crane_drip_batch_pods", "Pods per drip dispatch window",
                buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
            )
            self._m_kernel_s = reg.histogram(
                "crane_drip_kernel_seconds", "Drip batch-kernel wall seconds per dispatch",
                buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 1.0),
            )

    def register(self, plugin, weight: int = 1) -> None:
        """Order matters like the scheduler-config plugin list."""
        self._plugins.append(_WeightedPlugin(plugin, weight))
        # hook lists, plugin recognition and the column cache all key off
        # the registration list — rebuilt lazily on next use
        self._hooks = None
        self._drip = None
        self._recognized = False
        self._window_rec = False

    def drip_stats(self) -> dict:
        """Column-cache counters (hits/rebuilds/folds/drops/topk_*), the
        per-reason scalar-fallback histogram and the batch windows'
        distributions, with the host seconds of each window stage
        (``batch["stage_seconds"]``, ``DRIP_STAGES``), the batch
        kernel's CUDA-graph counters (``graph_captures``, ``graph_replays``,
        ``eager_windows``; ``replays`` counts tie replays), the windows
        whose steps ran the step kernel (``kernel_windows``) and the NRT
        window's (``zone_windows``: windows through ``drip_zone``;
        ``zone_results``: topology results written; ``cross_zone_binds``:
        bound pods whose result spans more than one zone)."""
        out = {"hits": 0, "rebuilds": 0, "folds": 0, "drops": 0,
               "topk_builds": 0, "topk_updates": 0}
        if self._drip is not None:
            out.update(self._drip.stats)
        out["fallbacks"] = dict(self._fallbacks)
        b = self._batch
        out["batch"] = {
            "dispatches": b["dispatches"],
            "pods": b["pods"],
            "replays": b["replays"],
            "conflicts": b["conflicts"],
            "zone_windows": b["zone_windows"],
            "zone_results": b["zone_results"],
            "cross_zone_binds": b["cross_zone_binds"],
            "batch_sizes": list(b["batch_sizes"]),
            "stage_seconds": dict(self._stages.seconds),
        }
        kern = self._batch_kernel
        for name in ("graph_captures", "graph_replays", "eager_windows", "kernel_windows"):
            out["batch"][name] = getattr(kern, name, 0)
        return out

    def _recognition(self):
        """Columnar eligibility of the registered plugin set: exactly one
        ``DynamicPlugin`` plus at most one ``ResourceFitPlugin`` (order
        free), as a ``_PluginSet``. Anything else — subclasses included,
        which may override hooks, and ``TopologyMatch``, which only the
        batched window serves — is unrecognized and pins the scalar loop."""
        if self._recognized is False:
            self._parse_plugins()
        return self._recognized

    def _window_recognition(self):
        """The batched window's eligibility: ``_recognition``'s plugin sets,
        and exactly one ``DynamicPlugin``, at most one
        ``ResourceFitPlugin`` and exactly one ``TopologyMatch`` (order
        free) — the NRT window, whose record carries ``topo``. The plugin
        must write to this scheduler's cluster, keep the default
        topology-aware resources (CPU) and have a lister with a
        ``version``; the window runs on one device. Anything else goes per
        pod."""
        if self._recognized is False:
            self._parse_plugins()
        return self._window_rec

    def _parse_plugins(self) -> None:
        """Read the registered plugin set once per registration into
        ``_recognized``, ``_window_rec`` and the fallback reason."""
        from ..fit.plugin import ResourceFitPlugin
        from ..plugins.dynamic import DynamicPlugin
        from ..topology.plugin import DEFAULT_TOPOLOGY_AWARE_RESOURCES, TopologyMatch

        dyn = tracker = topo = None
        dyn_weight = 1
        order: list[str] = []
        known = True
        for wp in self._plugins:
            p = wp.plugin
            if type(p) is DynamicPlugin and dyn is None:
                dyn, dyn_weight = p, wp.weight
                order.append("dyn")
            elif type(p) is ResourceFitPlugin and tracker is None:
                tracker = p.tracker
                order.append("fit")
            elif type(p) is TopologyMatch and topo is None:
                topo = (p, wp.weight)
                order.append("nrt")
            else:
                known = False
                break
        rec = None
        self._unrecognized_reason = "unknown_plugin"  # TopologyMatch's too, per pod
        if known and dyn is not None:
            rec = _PluginSet(dyn, dyn_weight, tracker, tuple(order), topo)
        elif known and topo is None:
            self._unrecognized_reason = "no_dynamic_plugin"
        self._recognized = rec if topo is None else None
        if topo is not None and rec is not None:
            plugin, mesh = topo[0], self._kernel_mesh
            if ((mesh is not None and mesh.size > 1) or plugin.cluster is not self.cluster
                    or plugin.topology_aware_resources != DEFAULT_TOPOLOGY_AWARE_RESOURCES
                    or not hasattr(plugin.lister, "version")):
                rec = None
        self._window_rec = rec

    def _count_fallback(self, reason: str) -> None:
        self._fallbacks[reason] = self._fallbacks.get(reason, 0) + 1
        if self._m_fallback is not None:
            self._m_fallback.labels(reason=reason).inc()

    def snapshot(self) -> list:
        """Informer-style snapshot (``NodeInfo`` per node), cached on
        ``cluster.sched_version``: our own binds fold in through
        ``_note_bind`` instead of a rebuild per pod."""
        v = self.cluster.sched_version
        if self._cache is not None and self._cache[0] == v:
            return self._cache[1]
        pods_by_node: dict[str, list[Pod]] = {}
        for pod in self.cluster.list_pods():
            if pod.node_name:
                pods_by_node.setdefault(pod.node_name, []).append(pod)
        snap = [
            NodeInfo(node=node, pods=pods_by_node.get(node.name, []))
            for node in self.cluster.list_nodes()
        ]
        self._cache = (v, snap)
        return snap

    def _note_bind(self, pod_key: str, node_name: str, pre_version: int, was_bound: bool) -> None:
        """Fold our own bind into the cached snapshot. Valid only when
        ``pre_version`` (read just before binding) still matches the
        cache's version: a concurrent writer's interleaved bump drops the
        cache instead. A clean fold stamps ``pre_version + 1`` (our bind's
        bump). A re-placement (``was_bound``) also drops it: the pod's old
        entry would linger on its former node."""
        cache = self._cache
        if cache is None:
            return
        if cache[0] != pre_version or was_bound:
            self._cache = None
            return
        bound = self.cluster.get_pod(pod_key)
        if bound is None:
            return
        for node_info in cache[1]:
            if node_info.node is not None and node_info.node.name == node_name:
                node_info.pods.append(bound)
                break
        self._cache = (pre_version + 1, cache[1])

    def schedule_one(self, pod: Pod) -> ScheduleResult:
        tel = self._telemetry
        if tel is None:
            return self._schedule_one(pod, None)
        reasons: dict[str, int] = {}
        # first-seen mints the pod's trace; the schedule_one span (and
        # everything under it) parents to that root context
        lc = tel.lifecycle
        ctx = lc.seen(pod.key(), source="drip")
        with tel.spans.span("schedule_one", ctx=ctx):
            result = self._schedule_one(pod, reasons, lc=lc)
        if result.node:
            lc.posted(pod.key(), node=result.node)
        self._m_decisions.labels(outcome="scheduled" if result.node else "failed").inc()
        tel.decisions.offer(self._decision_builder(result, reasons))
        return result

    @staticmethod
    def _decision_builder(result: ScheduleResult, reasons=None):
        """The lazy decision-trace entry of one drip placement: runs only
        when the sampling stride keeps it, and reads host columns only
        (the columnar path's reason histogram is a closure; the scalar
        loop's is the ``reasons`` dict it filled)."""

        def build():
            fr = result._reasons_fn() if result._reasons_fn is not None else (reasons or {})
            return dict(
                pod=result.pod_key,
                node=result.node,
                reason=result.reason,
                feasible=result.feasible,
                top_scores=result.top_scores(5),
                staleness_seconds=-1.0,  # drip reads the live cluster mirror
                source="drip",
                filter_reasons=fr,
            )

        return build

    def _schedule_one(self, pod: Pod, reasons: dict | None, lc=None) -> ScheduleResult:
        """Columnar fast path when the plugin set and the pod qualify,
        the scalar loop (the parity oracle) otherwise."""
        if self._columnar:
            rec = self._recognition()
            if rec is None:
                self._count_fallback(self._unrecognized_reason)
            else:
                fallback = self._columnar_ineligible(pod, rec)
                if fallback is None:
                    return self._schedule_one_columnar(pod, rec, lc=lc)
                self._count_fallback(fallback)
        return self._schedule_one_scalar(pod, reasons, lc=lc)

    @staticmethod
    def _columnar_ineligible(pod: Pod, rec) -> str | None:
        """Per-pod reasons the cached columns cannot express."""
        dyn, tracker = rec.dyn, rec.tracker
        if pod.is_daemonset_pod():
            return "daemonset"  # Dynamic Filter bypass is per-pod
        if dyn.degraded is not None and dyn.degraded.active:
            return "degraded"  # spread scoring reads per-node pod lists
        if tracker is not None:
            from ..fit.tracker import pod_fit_request

            if pod_fit_request(pod).scalar_resources:
                return "scalar_request"  # extended resources: dict path
        return None

    def _hook_lists(self) -> _Hooks:
        hooks = self._hooks
        if hooks is None:
            hooks = self._hooks = _Hooks(self._plugins)
        return hooks

    def _schedule_one_scalar(self, pod: Pod, reasons: dict | None = None,
                             lc=None) -> ScheduleResult:
        state = CycleState()
        nodes = self.snapshot()
        hooks = self._hook_lists()

        for pre in hooks.pre_filter:
            status = pre(state, pod)
            if not status.ok():
                return ScheduleResult(pod.key(), None, 0, status.reason)

        feasible = []
        last_reason = ""
        filters = hooks.filter
        for node_info in nodes:
            verdict = None
            for flt in filters:
                status = flt(state, pod, node_info)
                if not status.ok():
                    verdict = status
                    break
            if verdict is None:
                feasible.append(node_info)
            else:
                last_reason = verdict.reason
                if reasons is not None:
                    reasons[verdict.reason] = reasons.get(verdict.reason, 0) + 1
        if not feasible:
            return ScheduleResult(pod.key(), None, 0, last_reason or "no feasible nodes")
        if lc is not None:
            lc.stage(pod.key(), "filtered")

        # Score: weighted sum over score plugins
        totals: dict[str, int] = {}
        for node_info in feasible:
            total = 0
            for scr, weight in hooks.score:
                try:
                    value, status = scr(state, pod, node_info)
                except TypeError:
                    value, status = scr(state, pod, node_info.node.name)
                if not status.ok():
                    value = 0
                total += value * weight
            totals[node_info.node.name] = total

        # max score, first (snapshot order) among ties, or seeded-random
        # among ties when tie_break_seed is set
        best = max(feasible, key=lambda ni: totals[ni.node.name])
        if self._tie_rng is not None:
            top = totals[best.node.name]
            ties = [ni for ni in feasible if totals[ni.node.name] == top]
            if len(ties) > 1:
                best = ties[self._tie_rng.randrange(len(ties))]
        best_name = best.node.name

        for rsv in hooks.reserve:
            status = rsv(state, pod, best_name)
            if not status.ok():
                self._unreserve(state, pod, best_name)
                return ScheduleResult(pod.key(), None, len(feasible), status.reason)
        for pb in hooks.pre_bind:
            status = pb(state, pod, best_name)
            if not status.ok():
                self._unreserve(state, pod, best_name)
                return ScheduleResult(pod.key(), None, len(feasible), status.reason)

        if verbosity() >= 3:
            vlog(3, f"schedule_one {pod.key()}: {len(feasible)} feasible, "
                    f"picked {best_name} score {totals[best_name]}")
        # stage marks land before the bind: a confirming watch event may
        # finalize the record as soon as the bind is accepted
        if lc is not None:
            lc.stage(pod.key(), "scored", node=best_name)
        prev = self.cluster.get_pod(pod.key())
        was_bound = prev is not None and bool(prev.node_name)
        pre_version = self.cluster.sched_version
        if not self.cluster.bind_pod(pod.key(), best_name, self._clock()):
            # a failed bind must not stamp the snapshot cache: a phantom
            # pod at pre_version+1 would poison it
            self._unreserve(state, pod, best_name)
            return ScheduleResult(pod.key(), None, len(feasible), "bind failed")
        self._note_bind(pod.key(), best_name, pre_version, was_bound)
        return ScheduleResult(pod.key(), best_name, len(feasible), scores=totals)

    def _unreserve(self, state, pod: Pod, node_name: str) -> None:
        for un in self._hook_lists().unreserve:
            un(state, pod, node_name)

    def _ensure_drip(self, rec):
        from .drip import DripColumns

        drip = self._drip
        if drip is None:
            drip = self._drip = DripColumns(
                self.cluster, rec.dyn, rec.dyn_weight, rec.order, fit_tracker=rec.tracker,
                telemetry=self._telemetry, topology=None if rec.topo is None else rec.topo[0])
        return drip

    @staticmethod
    def _lazy_views(drip, vec):
        """Closures over the current columns: a lazy mask (materialized
        only when read) feeding the score dict, top-k and filter-reason
        builders."""
        names = drip.names
        weighted = drip.weighted
        mask_fn = drip.mask_closure(vec)

        def lazy_scores():
            return {names[int(i)]: int(weighted[i]) for i in np.flatnonzero(mask_fn())}

        def lazy_topk(k):
            import heapq

            return heapq.nsmallest(
                k,
                ((names[int(i)], int(weighted[i])) for i in np.flatnonzero(mask_fn())),
                key=lambda kv: (-kv[1], kv[0]),
            )

        def reasons():
            return drip.reason_counts(mask_fn(), vec)

        return lazy_scores, lazy_topk, reasons

    @staticmethod
    def _result(views, key, node, feasible, reason="") -> ScheduleResult:
        """A result over ``views`` (``_lazy_views``): the columns as they
        were when the views were taken."""
        lazy_scores, lazy_topk, reasons_fn = views
        if node is None:
            result = ScheduleResult(key, None, feasible, reason)
        else:
            result = ScheduleResult(key, node, feasible,
                                    lazy_scores=lazy_scores, lazy_topk=lazy_topk)
        result._reasons_fn = reasons_fn
        return result

    def _schedule_one_columnar(self, pod: Pod, rec, lc=None) -> ScheduleResult:
        """Vectorized drip placement over the cached cluster columns: an
        incremental segment-max read with the scalar loop's host selection
        — the tree's first-max descent matches ``np.argmax``, and the
        seeded tie-break consumes the RNG exactly like the scalar path, one
        ``randrange`` per real tie, selecting the r-th tie in snapshot
        order."""
        tracker = rec.tracker
        drip = self._ensure_drip(rec)
        # the Dynamic plugin's own clock: the scalar oracle stamps
        # freshness with dyn._clock(), and parity pins to that
        drip.ensure(rec.dyn._clock())
        names = drip.names
        n = len(names)
        vec = None
        if tracker is not None:
            from ..fit.tracker import pod_fit_request, request_vec

            vec = request_vec(pod_fit_request(pod))
        tree = drip.topk_for(vec)
        count = tree.feasible_count
        key = pod.key()
        # taken before the bind: a re-placement drops the fit column, and
        # the views keep reading the columns this decision was made on
        views = self._lazy_views(drip, vec)
        if count == 0:
            # scalar parity: the reported reason is the last infeasible
            # node's verdict in snapshot order
            reason = drip.reason_for(n - 1, vec) if n else ""
            return self._result(views, key, None, 0, reason or "no feasible nodes")
        if lc is not None:
            lc.stage(key, "filtered")

        best_i = tree.argmax_first()
        if self._tie_rng is not None:
            n_ties = tree.tie_count
            if n_ties > 1:
                best_i = tree.select_tie(self._tie_rng.randrange(n_ties))
        best_name = names[best_i]
        if verbosity() >= 3:
            vlog(3, f"schedule_one {key}: {count} feasible, "
                    f"picked {best_name} score {int(drip.weighted[best_i])}")

        if lc is not None:
            lc.stage(key, "scored", node=best_name)
        prev = self.cluster.get_pod(key)
        was_bound = prev is not None and bool(prev.node_name)
        pre_version = self.cluster.sched_version
        pre_pod = self.cluster.pod_version
        if not self.cluster.bind_pod(key, best_name, self._clock()):
            # same contract as the scalar loop: no snapshot stamp, no fold
            return self._result(views, key, None, count, "bind failed")
        self._note_bind(key, best_name, pre_version, was_bound)
        drip.note_bind(best_i, vec, pre_pod, was_bound)
        return self._result(views, key, best_name, count)

    # -- the batched window ----------------------------------------------

    def _window_fence(self, rec) -> tuple:
        """The versions a window's pods must all observe: the cluster's, and
        with NRT the lister's and the assume cache's."""
        cluster = self.cluster
        fence = (cluster.sched_version, cluster.pod_version, cluster.node_version)
        if rec.topo is not None:
            topo = rec.topo[0]
            fence += (topo.lister.version, topo.cache.version)
        return fence

    def _queue_fallback(self, pod: Pod, rec) -> str | None:
        """Why ``pod`` cannot join a window: a columnar fallback reason, or
        "rebind" for a re-placement, which moves load off a node mid-window
        (the per-pod path handles it and drops the fit column)."""
        fallback = self._columnar_ineligible(pod, rec)
        if fallback is None:
            prev = self.cluster.get_pod(pod.key())
            if prev is not None and prev.node_name:
                fallback = "rebind"
        return fallback

    @staticmethod
    def _request_row(pod: Pod, rec):
        from ..fit.tracker import pod_fit_request, request_vec

        return request_vec(pod_fit_request(pod)) if rec.tracker is not None else None

    def _nrt_request(self, pod: Pod) -> tuple[int, int]:
        """The NRT PreFilter of one pod: its guaranteed milli-CPU over the
        containers whose CPUs can be pinned (0: the plugin leaves the pod
        alone) and its awareness annotation (-1 absent, 0 false, 1 true)."""
        from ..topology.helper import (
            compute_container_specified_resource_request,
            get_pod_target_container_indices,
            is_pod_aware_of_topology,
        )
        from ..topology.plugin import DEFAULT_TOPOLOGY_AWARE_RESOURCES
        from ..topology.types import ANNOTATION_POD_CPU_POLICY, ANNOTATION_POD_TOPOLOGY_AWARENESS

        anno = pod.annotations or {}
        key = (id(pod.containers), anno.get(ANNOTATION_POD_CPU_POLICY),
               anno.get(ANNOTATION_POD_TOPOLOGY_AWARENESS))
        hit = self._nrt_rows.get(key)
        if hit is not None and hit[0] is pod.containers:
            return hit[1]
        indices = get_pod_target_container_indices(pod)
        req = compute_container_specified_resource_request(
            pod, indices, DEFAULT_TOPOLOGY_AWARE_RESOURCES).milli_cpu if indices else 0
        aware = is_pod_aware_of_topology(anno)
        row = (int(req), -1 if aware is None else int(aware))
        if len(self._nrt_rows) >= 1024:
            self._nrt_rows.clear()
        self._nrt_rows[key] = (pod.containers, row)
        return row

    def schedule_queue(self, pods, window: int = 32) -> list[ScheduleResult]:
        """Batched drip: coalesce pending pods into dispatch windows for
        ``scorer.drip_batch`` — one window of K dependent steps, one
        device-to-host copy, one bulk ``bind_pods`` — and route everything
        the columns cannot express (daemonset / degraded / scalar request /
        unrecognized plugin set / re-placement) through ``schedule_one`` at
        its queue position.

        Placements are identical to ``schedule_one`` per pod in order: a
        window only spans pods that observed identical cluster versions
        (an interleaved write flushes the open window first), the window
        folds sequentially so later pods see earlier binds, and under a
        seeded tie-break any window whose results report a real tie is
        replayed through the per-pod columnar path, consuming the RNG call
        for call."""
        results: list[ScheduleResult] = []
        rec = self._window_recognition() if self._columnar and window > 1 else None
        if rec is None:
            for pod in pods:
                results.append(self.schedule_one(pod))
            return results
        buf: list = []  # (pod, request vec) rows of the open window
        fence = None  # cluster versions the open window observed
        stages = self._stages
        # drip_admit runs from the call's start or a window's end to the
        # next window's start; it opens at the next pod, so no stage is
        # left open once the queue is through
        admit_from = stages.clock()
        for pod in pods:
            if admit_from is not None:
                stages.begin("drip_admit", admit_from)
                admit_from = None
            fallback = self._queue_fallback(pod, rec)
            if buf and (fallback is not None or self._window_fence(rec) != fence):
                admit_from = self._dispatch_window(buf, rec, results)
                buf = []
            if fallback is not None:
                # schedule_one re-derives and counts the fallback itself;
                # a per-pod placement is no stage of the window
                stages.stop()
                results.append(self.schedule_one(pod))
                admit_from = stages.clock()
                continue
            if not buf:
                fence = self._window_fence(rec)
            buf.append((pod, self._request_row(pod, rec)))
            if len(buf) >= window:
                admit_from = self._dispatch_window(buf, rec, results)
                buf = []
        if buf:
            self._dispatch_window(buf, rec, results)
        return results

    def _dispatch_window(self, buf, rec, results, _retry: int = 0) -> float:
        """One coalesced window: dispatch, then either accept (bulk bind +
        sequential host folds under the pre -> pre+n_bound stamp
        discipline) or replay per-pod (seeded tie in the window). The
        window is pure with respect to the host columns, so rejecting it
        costs only its own time. Returns the stage clock's reading at its
        end.

        Stages (``self._stages``): ``drip_prepare`` (column refresh, the
        request matrix, the uploads), ``drip_launch`` (the K-step enqueue),
        ``drip_wait`` (the fetch), ``drip_bind`` (lifecycle marks and
        ``bind_pods``), ``drip_fold`` (the results and the host folds). A
        rejected window keeps the first three; its per-pod replay is none.

        With ``rec.topo`` (``NodeResourceTopologyMatch``) the drip columns
        hold zone columns, and the window is the NRT window: it carries the
        zones' usage across its steps (``DripBatchKernel.dispatch_numa``),
        and each accepted bind does what the plugin's Reserve and PreBind
        do, for the whole window at once in the stage ``drip_zone``
        (``_zone_stage``) before ``bind_pods``. It also replays per pod
        where a feasible node's greedy pack uses no zone (the plugin's
        Score divides by zero), where a pod is already assumed or missing
        from the cluster, and where the zone columns hold what the window
        does not model (``ZoneColumns.clean``). Its results read the fit
        and zone columns as their pods saw them (``_numa_views``); the
        plain window's read the live columns (``_lazy_views``).

        Under ``conflict_retry`` the window re-reads the pod_version fence
        after the window and before the bind POSTs: a competing binder
        moving it means the placements were computed over stale free
        columns, so the window drops and retries at queue position
        (``_retry`` bounds the loop; exhaustion falls back to the per-pod
        path)."""
        tracker = rec.tracker
        if self.bind_backpressure is not None:
            self.bind_backpressure()
        k = len(buf)
        drip = self._ensure_drip(rec)
        zones = drip.zones
        tel = self._telemetry
        now = rec.dyn._clock()
        stages = self._stages
        t = stages.stop()  # the end of drip_admit
        with maybe_span(tel, "drip_dispatch", pods=k):
            stages.begin("drip_prepare", t)
            drip.ensure(now)
            if zones is not None and not zones.clean:
                stages.stop()
                return self._replay_per_pod(buf, results)
            names = drip.names
            n = len(names)
            vecs = np.zeros((k, 4), dtype=np.int64)
            if tracker is not None:
                for i, (_pod, vec) in enumerate(buf):
                    vecs[i] = vec
            if zones is not None:
                from ..scorer.drip_batch import numa_pod_rows

                nrt = np.array([self._nrt_request(pod) for pod, _vec in buf],
                               dtype=np.int64).reshape(k, 2)
                pod_rows = numa_pod_rows(nrt[:, 0], nrt[:, 1], rec.topo[1], zones.z)
            kern = self._kernel()
            cols = (drip.schedulable, drip.weighted, drip.bounded, drip.free, vecs)
            want_ties = self._tie_rng is not None
            t_upload = stages.clock()
            if zones is None:
                chosen, feasible, ties = kern.dispatch(
                    *cols, want_ties=want_ties, col_version=drip.col_epoch,
                    col_delta=drip.dirty_rows_between, stages=stages)
            else:
                chosen, feasible, ties, bad, takes = kern.dispatch_numa(
                    *cols, zones, pod_rows, want_ties=want_ties, col_version=drip.col_epoch,
                    col_delta=drip.dirty_rows_between, stages=stages)
            t_fetched = stages.stop()
        self._count_window(k, t_fetched - t_upload)
        if self._stale_window(tracker, drip, kern):
            if _retry < self.max_window_retries:
                return self._dispatch_window(buf, rec, results, _retry + 1)
            return self._replay_per_pod(buf, results)

        # a real tie consumes seeded RNG the window cannot replay, and a
        # pack over no zone is the plugin's division by zero: re-run the
        # whole window per-pod against the untouched host columns, with
        # identical placements and RNG consumption
        tied = want_ties and bool((ties > 1).any())
        if tied:
            self._batch["replays"] += 1
        if tied or (zones is not None and bool((bad[nrt[:, 0] > 0] > 0).any())):
            kern.mark_desynced()
            return self._replay_per_pod(buf, results)

        if zones is None:
            stages.begin("drip_bind", t_fetched)
        else:
            zoned = self._zone_stage(buf, rec.topo[0], zones, chosen, takes, kern, t_fetched)
            if zoned is None:
                return self._replay_per_pod(buf, results)
            entries, pre_cache = zoned
        lc = self._mark_scored(buf, chosen, names)
        pairs = [
            (pod.key(), names[int(chosen[i])])
            for i, (pod, _vec) in enumerate(buf)
            if chosen[i] >= 0
        ]
        pre_pod = self.cluster.pod_version
        bound = self.cluster.bind_pods(pairs, self._clock()) if pairs else []
        stages.split("drip_fold")
        bound_set = set(bound)
        n_bound = len(bound)
        # fold discipline, checked once for the window: the fit column must
        # still be at the pre-bind stamp and pod_version must have moved
        # exactly by our own n_bound binds — then the window's sequential
        # folds replay row by row on the host copy (so an infeasible pod's
        # reason later in the window reads the free state the per-pod path
        # would have seen)
        ok_folds = (
            n_bound == len(pairs)
            and self.cluster.pod_version == pre_pod + n_bound
            and (tracker is None or (drip.free is not None and drip._fit_pod_ver == pre_pod))
        )
        folds = None
        if zones is None:
            ok_folds = ok_folds and tracker is not None  # nothing to fold without Fit
        else:
            folds, zones_ok = self._zone_folds(drip, rec.topo[0], entries, bound_set,
                                               pre_pod, pre_cache)
            ok_folds = ok_folds and zones_ok
        fold_rows = []
        for i, (pod, vec) in enumerate(buf):
            key = pod.key()
            ci = int(chosen[i])
            if folds is None:
                views = self._lazy_views(drip, vec)
            else:
                views = self._numa_views(drip, vec, pod_rows[i], folds, len(fold_rows))
            if ci < 0:
                reason = ""
                if n:
                    code = (-1 if folds is None
                            else drip.nrt_code(n - 1, pod_rows[i], zones.used))
                    reason = drip.reason_for(n - 1, vec, code)
                result = self._result(views, key, None, 0, reason or "no feasible nodes")
            elif key in bound_set:
                if ok_folds and folds is None:
                    drip.fold_row(ci, vec)  # and the per-pod path's SegMaxTree updates
                elif ok_folds:
                    if tracker is not None:
                        drip.free[ci] -= vec
                    zones.fold(ci, takes[i])
                    fold_rows.append(i)
                if lc is not None:
                    lc.posted(key, node=names[ci])
                result = self._result(views, key, names[ci], int(feasible[i]))
            else:
                result = self._result(views, key, None, int(feasible[i]), "bind failed")
            if tel is not None:
                self._m_decisions.labels(outcome="scheduled" if result.node else "failed").inc()
                tel.decisions.offer(self._decision_builder(result))
            results.append(result)
        if ok_folds:
            if folds is not None:
                drip.stats["folds"] += len(fold_rows)
                drip.close_folds(folds, chosen[fold_rows].astype(np.int64), vecs[fold_rows],
                                 takes[fold_rows])
                zones.commit(pre_pod + n_bound, pre_cache + len(entries))
            if tracker is not None:
                drip.commit_folds(pre_pod + n_bound)
            # the host replayed the window's exact integer folds, so the
            # device carries mirror the host columns bit for bit
            kern.mark_synced(drip.free, None if zones is None else zones.used)
        else:
            if tracker is not None:
                drip.drop_fit()
            kern.mark_desynced()
        return stages.stop()

    def _zone_stage(self, buf, topo, zones, chosen, takes, kern, t_fetched):
        """The NRT window's stage ``drip_zone``: the plugin's Reserve and
        PreBind for every pod that takes a zone (``commit_results``: the
        zone result assumed in the cache and written onto the pod as its
        topology-result annotation). Returns ``(entries, pre_cache)`` with
        ``drip_bind`` open, or None when the cache refused them (the stage
        closed and the carries desynced: the window replays per pod)."""
        stages = self._stages
        stages.begin("drip_zone", t_fetched)
        entries = [(buf[i][0], *self._zone_result(zones, int(chosen[i]), takes[i]))
                   for i in np.flatnonzero((chosen >= 0) & takes.any(axis=1)).tolist()]
        pre_cache = topo.cache.version
        if entries and not topo.commit_results(entries):
            stages.stop()
            kern.mark_desynced()
            return None
        self._batch["zone_windows"] += 1
        self._batch["zone_results"] += len(entries)
        stages.split("drip_bind")
        return entries, pre_cache

    def _zone_folds(self, drip, topo, entries, bound_set, pre_pod, pre_cache):
        """The NRT window's binds in the zone columns: the per-pod cycle's
        Unreserve for each pod whose bind failed, the cross-zone count, and
        the ``_Folds`` record the window's zone folds go into
        (``DripColumns.open_folds``). Returns the record and whether the
        zone columns and the cache moved by the window's own assumes
        alone."""
        unbound = [pod for pod, _zl, _raw in entries if pod.key() not in bound_set]
        if unbound:
            topo.cache.forget_pods(unbound)
        self._batch["cross_zone_binds"] += sum(len(zl) > 1 for pod, zl, _raw in entries
                                               if pod.key() in bound_set)
        ok = (drip.zones.stamps() == (pre_pod, pre_cache)
              and topo.cache.version == pre_cache + len(entries))
        return drip.open_folds(), ok

    def _count_window(self, k: int, kernel_s: float) -> None:
        """A dispatched window's counts and metrics (``kernel_s``: the
        uploads, the launch and the wait)."""
        b = self._batch
        b["dispatches"] += 1
        b["pods"] += k
        if len(b["batch_sizes"]) < 4096:
            b["batch_sizes"].append(k)
        if self._m_batch_pods is not None:
            self._m_batch_pods.observe(k)
            self._m_kernel_s.observe(kernel_s)

    def _stale_window(self, tracker, drip, kern) -> bool:
        """Under ``conflict_retry``: whether another binder moved
        ``pod_version`` under the window. Nothing was POSTed (the window is
        pure), so it is dropped, to be retried at queue position over
        rebuilt columns or, after ``max_window_retries``, placed per pod."""
        if not (self.conflict_retry and tracker is not None and drip.free is not None
                and self.cluster.pod_version != drip._fit_pod_ver):
            return False
        kern.mark_desynced()
        drip.drop_fit()
        self._batch["conflicts"] += 1
        if self.conflict_cb is not None:
            self.conflict_cb("stale_window")
        return True

    def _mark_scored(self, buf, chosen, names):
        """The lifecycle's marks for a window's pods, before the bind (as
        on the per-pod path); returns the lifecycle, or None."""
        tel = self._telemetry
        lc = tel.lifecycle if tel is not None else None
        if lc is not None:
            for i, (pod, _vec) in enumerate(buf):
                key = pod.key()
                lc.seen(key, source="drip")
                if chosen[i] >= 0:
                    lc.stage(key, "filtered")
                    lc.stage(key, "scored", node=names[int(chosen[i])])
        return lc

    def _kernel(self):
        from ..scorer.drip_batch import DripBatchKernel

        kern = self._batch_kernel
        if kern is None:
            kern = self._batch_kernel = DripBatchKernel(device=self.device,
                                                        mesh=self._kernel_mesh)
        return kern

    def _replay_per_pod(self, buf, results) -> float:
        """A rejected window's pods, one by one at their queue positions
        (no stage of the window)."""
        for pod, _vec in buf:
            results.append(self.schedule_one(pod))
        return self._stages.clock()

    @staticmethod
    def _zone_result(zones, row: int, take) -> tuple:
        """The plugin's zone result for a bind on ``row`` that takes
        ``take`` milli-CPU per zone (CR order): the zones sorted by name,
        each with its CPU as capacity, and their annotation text."""
        from ..topology.types import ZONE_TYPE_NODE, Zone, ZoneResourceInfo, zones_to_json

        names = zones.zone_names[int(zones.layout[row])]
        key = (names, tuple(int(t) for t in take))
        hit = zones.results.get(key)
        if hit is None:
            if len(zones.results) >= 4096:
                zones.results.clear()
            zl = sorted((Zone(name=names[j], type=ZONE_TYPE_NODE,
                              resources=ZoneResourceInfo(capacity={"cpu": f"{t}m"}))
                         for j, t in enumerate(key[1]) if t > 0), key=lambda zn: zn.name)
            hit = zones.results[key] = (tuple(zl), zones_to_json(zl))
        return list(hit[0]), hit[1]

    @staticmethod
    def _numa_views(drip, vec, pod_row, folds, j):
        """``_lazy_views`` of an NRT window's result: the fit and zone
        columns as its pod saw them (``columns_at``: ``folds`` up to its
        place ``j`` in the window), scored with the window's own step
        (``numa_eval``)."""
        import heapq

        from ..scorer.drip_batch import numa_eval
        from .drip import columns_at

        zones = drip.zones
        names = drip.names
        cols = (drip.schedulable, drip.weighted, drip.bounded)
        free, used = drip.free, zones.used
        zcols = (zones.zkey, zones.zcap, zones.has, zones.active, zones.act_naw)

        def state():
            f, u = columns_at(folds, j, free, used)
            mask, total, _idx = numa_eval(*cols, f, vec, zcols, u, pod_row)
            return f, u, mask, total

        def lazy_scores():
            _f, _u, mask, total = state()
            return {names[int(i)]: int(total[i]) for i in np.flatnonzero(mask)}

        def lazy_topk(k):
            _f, _u, mask, total = state()
            return heapq.nsmallest(k, ((names[int(i)], int(total[i]))
                                       for i in np.flatnonzero(mask)),
                                   key=lambda kv: (-kv[1], kv[0]))

        def reasons():
            f, u, mask, _total = state()
            return drip.reason_counts(mask, vec, nrt=drip.nrt_codes(pod_row, u), free=f)

        return lazy_scores, lazy_topk, reasons

    def open_queue(self, window: int = 32) -> "DripQueue":
        """An incremental front end to ``schedule_queue`` for a serving
        loop: pods arrive one at a time (``offer``), windows fire under the
        batched path's fence and fallback discipline, and ``drain()``
        flushes a half-filled window on demand (the SIGTERM hook)."""
        return DripQueue(self, window)


class DripQueue:
    """Incremental drip window over a ``Scheduler`` (``open_queue``).

    ``offer(pod)`` buffers columnar-eligible pods and dispatches a window
    when it fills, when the cluster version fence moves, or when a
    fallback pod interleaves — the window semantics of one
    ``schedule_queue`` call spread across arrivals, so placements equal
    the batched path's over the same pod sequence. ``drain()`` dispatches
    whatever is buffered. Not thread-safe — one serving loop owns it."""

    def __init__(self, scheduler: Scheduler, window: int = 32):
        self._s = scheduler
        self.window = max(1, int(window))
        self.results: list[ScheduleResult] = []
        self._buf: list = []  # (pod, request vec) rows of the open window
        self._fence = None
        self._rec = None  # the _PluginSet the open window captured

    def __len__(self) -> int:
        return len(self._buf)

    @property
    def pending(self) -> list:
        """Keys buffered in the open window (oldest first)."""
        return [pod.key() for pod, _vec in self._buf]

    def offer(self, pod) -> None:
        s = self._s
        rec = s._window_recognition() if s._columnar and self.window > 1 else None
        if rec is None:
            # scalar-pinned plugin set: nothing may sit buffered behind a
            # per-pod decision (ordering), so flush, then go scalar
            self.drain()
            self.results.append(s.schedule_one(pod))
            return
        fallback = s._queue_fallback(pod, rec)
        if self._buf and (
            fallback is not None or s._window_fence(rec) != self._fence or rec is not self._rec
        ):
            self.drain()
        if fallback is not None:
            # schedule_one re-derives and counts the fallback itself
            self.results.append(s.schedule_one(pod))
            return
        if not self._buf:
            self._fence = s._window_fence(rec)
            self._rec = rec
        self._buf.append((pod, s._request_row(pod, rec)))
        if len(self._buf) >= self.window:
            self.drain()

    def drain(self) -> int:
        """Dispatch the open window (no-op when empty). Returns how many
        buffered pods were dispatched."""
        if not self._buf:
            return 0
        buf, self._buf = self._buf, []
        self._s._dispatch_window(buf, self._rec, self.results)
        return len(buf)

    def take_results(self) -> list[ScheduleResult]:
        out, self.results = self.results, []
        return out
