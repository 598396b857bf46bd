"""Burst scheduling on one GPU: bulk refresh -> fused score -> gang assign.

Counterpart of ``BatchScheduler`` in ``crane_scheduler_tpu/framework/
scheduler.py``, for the main path: ``refresh`` (the object path),
``_prepare`` (resident-snapshot hit and full upload), ``schedule_batch``
over ``Pod`` objects, and the columnar ``schedule_pod_burst`` /
``schedule_bursts_pipelined``. Placements are bit-identical to the
reference: the same solver, the same ``_expand_counts`` order.

The Dynamic score is pod-independent, so a burst of non-DaemonSet pods
shares one score vector; placement spreads via the in-batch hot-value
penalty (see ``scorer.topk``). DaemonSet pods bypass Filter per the
reference and are scheduled individually by the caller.
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..cluster.state import ClusterState, Pod
from ..device import resolve_device
from ..loadstore.store import NodeLoadStore
from ..parallel.step import PackedFetch, ScheduleStep
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


class BatchScheduler:
    """GPU burst mode: bulk refresh -> fused score -> gang assign -> bind."""

    def __init__(
        self,
        cluster: ClusterState,
        policy: DynamicSchedulerPolicy,
        dtype=None,
        clock=time.time,
        snapshot_bucket: int = 2048,
        telemetry=None,
        device=None,
    ):
        """``dtype``: ``torch.float64`` (default) is the parity mode;
        ``torch.float32`` is the fast mode, always hybrid (f64 rescue rows)
        so placements stay bit-identical to f64/Go.
        ``device``: ``None`` means the GPU (raises without one); tests pass
        ``"cpu"``. ``telemetry`` must be None: spans and counters are not
        part of this port yet."""
        if telemetry is not None:
            raise NotImplementedError("telemetry is not ported; pass telemetry=None")
        self.cluster = cluster
        self.policy = policy
        self.tensors = compile_policy(policy)
        self.store = NodeLoadStore(self.tensors)
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
            "full": 0,  # full snapshot + H2D upload
            "ingest_ms": 0.0,  # host ms spent in refresh() bulk ingest
            "risk_rescan_rows": 0,  # rows the hybrid f64 risk scan touched
        }
        self._prepared = None  # resident PreparedSnapshot
        self._prepared_key = None  # store version it was built from
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

    def _stage(self, name: str, t0: float) -> float:
        t = time.perf_counter()
        self.burst_stage_ms[name] += (t - t0) * 1e3
        return t

    def refresh(self) -> None:
        """Bulk re-ingest node annotations (the store is a cache)."""
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

    def _prepare(self, now: float):
        """Reuse the resident snapshot when the store is unchanged (in
        hybrid mode refreshing the f64 rescue vectors for ``now``, which
        also re-rebases an over-aged f32 snapshot), else snapshot the
        store and upload it."""
        if self._prepared is not None and self._prepared_key == self.store.version:
            self.refresh_stats["hit"] += 1
            if self._hybrid:
                self._prepared = self._step.with_overrides(
                    self._prepared, self._prepared_snap, now
                )
                self._note_rescan()
            return self._prepared

        self.refresh_stats["full"] += 1
        snap = self.store.snapshot(bucket=self._bucket)
        self._prepared = self._step.prepare(snap, now)
        self._note_rescan()
        self._prepared_key = snap.version
        # only hybrid override refreshes re-read the host snapshot
        self._prepared_snap = snap if self._hybrid else None
        self._prepared_names = snap.node_names
        self._prepared_n = snap.n_nodes
        return self._prepared

    def schedule_batch(self, pods: list[Pod]) -> BatchResult:
        now = self._clock()
        self.refresh()
        prepared = self._prepare(now)
        # the cycle's single device->host fetch
        packed = self._step.packed(prepared, len(pods), now=now).result()
        keys = [pod.key() for pod in pods]
        result = self._build_result(packed, keys, now=now)
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

    # -- columnar bursts (pods as rows, binds as one array transaction) ----

    def schedule_pod_burst(self, namespace: str, names: list) -> BurstResult:
        """Schedule a burst of bare pods as one column: placements come
        back as an int32 column, binds apply through
        ``ClusterState.bind_burst`` in one transaction. Placement-identical
        to ``schedule_batch`` over equivalent ``Pod`` objects."""
        for result in self.schedule_bursts_pipelined([(namespace, names)], depth=1):
            return result
        raise RuntimeError("empty burst stream")  # pragma: no cover

    def schedule_bursts_pipelined(self, bursts, depth: int = 4):
        """Pipelined columnar bursts: ``bursts`` yields ``(namespace,
        names)`` pairs; one ``BurstResult`` per burst, in order. Up to
        ``depth`` cycles are dispatched ahead, each with its device->host
        copy started at dispatch; at depth > 1 one worker thread waits on
        the copies, while all cluster mutation stays on this thread. A
        cycle's snapshot cannot see the previous ``depth - 1`` cycles'
        binds (bounded feedback lag, as in the reference). This is a
        generator: nothing is dispatched until it is iterated."""
        if depth < 1:
            raise ValueError("depth must be >= 1")
        pending = deque()
        pool = (
            ThreadPoolExecutor(max_workers=1, thread_name_prefix="d2h-fetch")
            if depth > 1 else None
        )
        try:
            for namespace, names in bursts:
                now = self._clock()
                t = time.perf_counter()
                self.refresh()
                t = self._stage("refresh", t)
                prepared = self._prepare(now)
                t = self._stage("prepare", t)
                fetch = self._step.packed(prepared, len(names), now=now)
                t = self._stage("dispatch", t)
                handle = self.cluster.add_pod_burst(namespace, names)
                self._stage("add_pod_burst", t)
                pending.append((
                    _submit_fetch(pool, fetch), namespace, names, handle, now,
                    self._prepared_names, self._prepared_n,
                ))
                if len(pending) >= depth:
                    yield self._drain_burst(pending.popleft())
            while pending:
                yield self._drain_burst(pending.popleft())
        finally:
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)

    def _drain_burst(self, item) -> BurstResult:
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
        bound = self.cluster.bind_burst(handle, table, node_idx, now)
        if len(bound) != int((node_idx >= 0).sum()):
            # reconcile with what actually bound (rows deleted between
            # dispatch and drain)
            mask = np.zeros((len(names),), dtype=bool)
            mask[bound] = True
            node_idx = np.where(mask, node_idx, -1).astype(np.int32)
        self._stage("bind", t)
        return BurstResult(
            namespace=namespace,
            names=names,
            node_idx=node_idx,
            node_table=table,
            bound_rows=bound,
            scores_row=scores,
            schedulable_row=np.asarray(schedulable),
            now=now,
        )

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

    def _build_result(self, packed, keys, now: float) -> BatchResult:
        """Host result of one batch over the current prepared snapshot."""
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
