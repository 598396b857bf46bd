"""Burst scheduling on one GPU: bulk refresh -> fused score -> gang assign.

Counterpart of ``BatchScheduler`` in ``crane_scheduler_tpu/framework/
scheduler.py``, for the main path: ``refresh`` (the object path, or
nothing in direct mode, where the annotator writes a shared store),
``_prepare`` (resident-snapshot hit, column-write replay, row delta, full
upload), ``schedule_batch`` and ``schedule_batches_pipelined`` over
``Pod`` objects, and the columnar ``schedule_pod_burst`` /
``schedule_bursts_pipelined``. Both pipelined loops can overlap the
refresh (``_OverlappedRefresh``) and the binds (``_BindFlushQueue``) with
the next cycle; those workers touch the store and the cluster, never a
tensor. Placements are bit-identical to the reference: the same solver,
the same ``_expand_counts`` order.

The Dynamic score is pod-independent, so a burst of non-DaemonSet pods
shares one score vector; placement spreads via the in-batch hot-value
penalty (see ``scorer.topk``). DaemonSet pods bypass Filter per the
reference and are scheduled individually by the caller.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..cluster.state import ClusterState, Pod
from ..device import resolve_device
from ..loadstore.store import NodeLoadStore
from ..parallel.step import EPOCH_REBASE_SECONDS, PackedFetch, ScheduleStep
from ..policy.compile import compile_policy
from ..policy.types import DynamicSchedulerPolicy
from ..utils.logging import verbosity, vlog

# stages of one burst cycle, in order (see ``BatchScheduler.burst_stage_ms``)
BURST_STAGES = ("refresh", "prepare", "dispatch", "add_pod_burst", "wait", "expand", "bind")


def _submit_fetch(pool, fetch: PackedFetch) -> Future:
    """Future of a started device->host fetch: waited on the pool's worker
    when pipelining (the done-callback retrieves any exception, so an
    abandoned generator leaves none unread), inline at depth 1."""
    if pool is None:
        fut = Future()
        fut.set_result(fetch.result())
        return fut
    fut = pool.submit(fetch.result)
    fut.add_done_callback(lambda f: f.cancelled() or f.exception())
    return fut


@dataclass
class BatchResult:
    assignments: dict  # pod_key -> node name
    unassigned: list  # pod keys with no capacity
    scores: dict  # node name -> int score
    schedulable: dict  # node name -> bool
    now: float = 0.0  # scheduling time the device scored at


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
        self._worker = threading.Thread(target=self._run, daemon=True, name="bind-flush")
        self._worker.start()

    # -- producer side (scheduling thread) --------------------------------

    def submit_batch(self, result: "BatchResult", now: float) -> None:
        with self._lock:
            self._outstanding += 1
            self._outstanding_pods += len(result.assignments)
        self._q.put(("batch", result, now))

    def submit_burst(self, namespace: str, names: list, node_table, node_idx,
                     result: "BurstResult", now: float) -> None:
        with self._lock:
            self._outstanding += 1
            self._outstanding_pods += len(names)
        self._q.put(("burst", namespace, names, node_table, node_idx, result, now))

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
            with self._drained:
                self._outstanding -= len(window)
                self._outstanding_pods = max(0, self._outstanding_pods - count)
                self._drained.notify_all()

    def _flush_window_inner(self, window: list) -> None:
        cluster = self._scheduler.cluster
        batches = [i for i in window if i[0] == "batch"]
        bursts = [i for i in window if i[0] == "burst"]
        if batches:
            # one merged bind transaction for the window's batch results
            merged: dict = {}
            for _, result, _now in batches:
                merged.update(result.assignments)
            bound = set(cluster.bind_pods(merged, batches[-1][2]))
            for _, result, _now in batches:
                failed = [k for k in result.assignments if k not in bound]
                for k in failed:
                    del result.assignments[k]
                result.unassigned.extend(failed)
        if bursts:
            # creations first (a bind of an uncreated pod is refused)
            handles = [cluster.add_pod_burst(ns, names)
                       for _, ns, names, _t, _i, _r, _n in bursts]
            now = bursts[-1][6]
            for handle, (_, _ns, _names, table, node_idx, result, _now) in zip(handles, bursts):
                bound = cluster.bind_burst(handle, table, node_idx, now)
                result.bound_rows = bound
                node_idx = np.asarray(result.node_idx)
                if len(bound) != int((node_idx >= 0).sum()):
                    mask = np.zeros((len(node_idx),), dtype=bool)
                    mask[bound] = True
                    result.node_idx = np.where(mask, node_idx, -1).astype(np.int32)


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
    ):
        """``dtype``: ``torch.float64`` (default) is the parity mode;
        ``torch.float32`` is the fast mode, always hybrid (f64 rescue rows)
        so placements stay bit-identical to f64/Go.
        ``store``/``refresh_from_cluster``: direct mode. Pass a store the
        annotator writes (``bulk_set_by_name``, ``set_metric``) with
        ``refresh_from_cluster=False`` and ``refresh`` re-ingests nothing;
        the store's versions still drive the device snapshot.
        ``device``: ``None`` means the GPU (raises without one); tests pass
        ``"cpu"``. ``telemetry`` must be None: spans and counters are not
        part of this port yet."""
        if telemetry is not None:
            raise NotImplementedError("telemetry is not ported; pass telemetry=None")
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
        self.device = resolve_device(device)
        self._step = ScheduleStep(
            self.tensors, dtype=dtype or torch.float64, device=self.device
        )
        self._hybrid = self._step.hybrid
        self.scorer = self._step.scorer
        self.gang = self._step.gang
        # which upload path served each _prepare call
        self.refresh_stats = {
            "hit": 0,  # unchanged store, resident snapshot reused
            "columns": 0,  # column-log replay ([N] vectors per column)
            "delta": 0,  # row-delta scatter
            "full": 0,  # full snapshot + H2D upload
            "ingest_ms": 0.0,  # host ms spent in refresh() bulk ingest
            "risk_rescan_rows": 0,  # rows the hybrid f64 risk scan touched
            # pipelined cycles served without waiting for an in-flight
            # background refresh (overlap_refresh)
            "overlap_hits": 0,
        }
        self._prepared = None  # resident PreparedSnapshot
        self._prepared_key = None  # store version it was built from
        self._prepared_layout = None  # store layout version it was built from
        self._prepared_snap = None  # host snapshot behind it (hybrid only)
        self._prepared_names: tuple[str, ...] = ()
        self._prepared_n = 0
        self._rescan_counted = None
        self._node_table_cache = None
        # host ms per stage of the burst cycle, summed over bursts (reset
        # by assigning a fresh ``dict.fromkeys(BURST_STAGES, 0.0)``). No
        # device syncs: "dispatch" is the step's launch cost and "wait"
        # holds whatever device and copy time the host did not overlap.
        self.burst_stage_ms = dict.fromkeys(BURST_STAGES, 0.0)
        # the bind-flush windows of the last pipelined run with
        # overlap_bind (``_BindFlushQueue.stats``), else None
        self.bind_flush_stats = None

    def _stage(self, name: str, t0: float) -> float:
        t = time.perf_counter()
        self.burst_stage_ms[name] += (t - t0) * 1e3
        return t

    def refresh(self) -> None:
        """Bulk re-ingest node annotations (the store is a cache). A
        direct-mode store skips this: the annotator keeps it current."""
        if not self._refresh_from_cluster:
            return
        t0 = time.perf_counter()
        nodes = self.cluster.list_nodes()
        self.store.bulk_ingest((n.name, n.annotations) for n in nodes)
        self.store.prune_absent(n.name for n in nodes)
        self.refresh_stats["ingest_ms"] += (time.perf_counter() - t0) * 1e3

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
        now = self._clock()
        self.refresh()
        prepared = self._prepare(now)
        # the cycle's single device->host fetch
        packed = self._step.packed(prepared, len(pods), now=now).result()
        keys = [pod.key() for pod in pods]
        result = self._build_result(packed, keys, now=now)
        if bind:
            self._apply_binds(result, now)
        if verbosity() >= 2:
            vlog(2, f"batch cycle: {len(result.assignments)}/{len(pods)} "
                    f"assigned, {len(result.unassigned)} unassigned")
        return result

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

    def _dispatch_batch(self, pool, item, now: float, t: float, bind: bool, bindq):
        _, pods = item
        prepared = self._prepare(now)
        t = self._stage("prepare", t)
        fetch = self._step.packed(prepared, len(pods), now=now)
        self._stage("dispatch", t)
        return (_submit_fetch(pool, fetch), [pod.key() for pod in pods], now,
                self._prepared_names, self._prepared_n)

    def _drain_pipelined(self, pending, bind: bool, bindq=None) -> BatchResult:
        fut, keys, now, names, n = pending
        packed = fut.result()  # the only synchronization point
        result = self._build_result(packed, keys, now=now, names=names, n=n)
        if bind:
            if bindq is not None:
                bindq.submit_batch(result, now)
            else:
                self._apply_binds(result, now)
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

    def _dispatch_burst(self, pool, item, now: float, t: float, bind: bool, bindq):
        namespace, names = item
        prepared = self._prepare(now)
        t = self._stage("prepare", t)
        fetch = self._step.packed(prepared, len(names), now=now)
        t = self._stage("dispatch", t)
        # with a bind queue the creation rides the flush worker, ordered
        # before the bind on its FIFO
        handle = self.cluster.add_pod_burst(namespace, names) if bind and bindq is None else None
        self._stage("add_pod_burst", t)
        return (_submit_fetch(pool, fetch), namespace, names, handle, now,
                self._prepared_names, self._prepared_n)

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
        pool = (
            ThreadPoolExecutor(max_workers=1, thread_name_prefix="d2h-fetch")
            if depth > 1 else None
        )
        self.bind_flush_stats = bindq.stats if bindq is not None else None
        try:
            for item in items:
                if bindq is not None and bind_watermark_pods:
                    bindq.wait_below(bind_watermark_pods)
                now = self._clock()
                t = time.perf_counter()
                if refresher is not None:
                    refresher.tick()
                else:
                    self.refresh()
                t = self._stage("refresh", t)
                pending.append(dispatch(pool, item, now, t, bind, bindq))
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
        fut, namespace, names, handle, now, node_names, n = item
        t = time.perf_counter()
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
        t = self._stage("expand", t)
        bound = None
        if bind and handle is not None:
            bound = self.cluster.bind_burst(handle, table, node_idx, now)
            if len(bound) != int((node_idx >= 0).sum()):
                # reconcile with what actually bound (rows deleted between
                # dispatch and drain)
                mask = np.zeros((len(names),), dtype=bool)
                mask[bound] = True
                node_idx = np.where(mask, node_idx, -1).astype(np.int32)
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
            bindq.submit_burst(namespace, names, table, node_idx, result, now)
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

    def _build_result(self, packed, keys, now: float, names=None, n=None) -> BatchResult:
        """Host result of one batch; ``names``/``n`` default to the current
        prepared snapshot (the pipelined loop passes the values captured
        at dispatch)."""
        if names is None:
            names, n = self._prepared_names, self._prepared_n
        schedulable, scores, counts, _unassigned, _ = ScheduleStep.unpack(packed, n)
        assignments, unassigned = self._expand_counts(scores, counts, names, keys)
        return BatchResult(
            assignments=assignments,
            unassigned=unassigned,
            scores={names[i]: int(scores[i]) for i in range(n)},
            schedulable={names[i]: bool(schedulable[i]) for i in range(n)},
            now=now,
        )
