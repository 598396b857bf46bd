"""Version-cached cluster columns for the per-pod ("drip") fast path.

Counterpart of ``DripColumns`` and ``GangColumns`` in
``crane_scheduler_tpu/framework/drip.py``. Node-version changes the
cluster's dirty-name journal covers re-read only the journal's names
(``_apply_dirty``) and recompute only their column rows in place
(``_patch_dynamic``); the scatter log behind ``dirty_rows_between`` carries
those rows to the device column cache. An uncovered interval (a columnar
sweep, a journal overrun) takes exactly one identity sweep
(``full_sweeps``). ``GangColumns`` is the gang engine's subclass: the same
caches under the ``crane_gang_column_*`` families, plus an interned
accelerator-type column.

The scalar ``Scheduler._schedule_one`` loop is O(plugins x nodes) per
pod. But the verdicts it computes are almost entirely pod-independent:
the Dynamic Filter/Score read only node annotations and the clock, and
ResourceFit reads the free allocatable columns against a per-pod request
row. ``DripColumns`` computes both once as cluster-wide numpy columns and
caches them on the versions that can change them:

- **Dynamic column** — keyed on ``(cluster.node_version, store.version,
  clock bucket)``. Node annotations feed a private ``NodeLoadStore``
  (bulk, identity-gated: an annotator sweep re-parses only rows whose
  annotation map object changed), and the columns come from
  ``scorer.columns.drip_filter_score_columns`` — the same IEEE-double op
  sequence the parity suite pins to the scalar oracle. The clock bucket
  bounds staleness of the fail-open freshness windows between store
  writes (default 0.25 s; fixed-clock tests always hit).

- **Fit column** — keyed on ``(cluster.pod_version,
  cluster.node_version)``. ``FitTracker.free_matrix`` hands back aligned
  *copies* of the free-allocatable rows, so the scheduler's own binds fold
  in place (subtract the request row) under the same stamp discipline
  ``Scheduler._note_bind`` uses for the snapshot cache: fold only when
  ``pod_version`` moved exactly from the pre-bind stamp to pre+1 (our own
  bump), drop on any interleaved writer or pod re-placement.

- **Zone columns** (``ZoneColumns``, the NRT drip window only) — each
  node's NodeResourceTopology CR and the milli-CPU its NUMA zones hold,
  keyed on the lister's version, ``cluster.pod_version`` and the assume
  cache's versions, folded in place by the window's own binds.

Per-pod work is then one ``free >= request`` broadcast, one mask AND and
one argmax (or an O(log n) ``SegMaxTree`` read) with no Python per-node
loop. Everything the columns cannot express (daemonset bypass, degraded
mode, third-party plugins, scalar extended resources) falls back to the
scalar loop, which stays the bit-identical parity oracle.
"""

from __future__ import annotations

import functools

import numpy as np

from ..fit.tracker import fail_code_reason, row_fail_reason, rows_fail_codes
from ..loadstore.store import NodeLoadStore
from ..policy.compile import compile_policy
from ..scorer.columns import (
    drip_filter_score_columns,
    fail_metric_name,
    fail_metric_names,
)
from ..scorer.topk import SegMaxTree
from ..telemetry import maybe_span
from ..topology.types import (
    ANNOTATION_POD_TOPOLOGY_RESULT,
    CPU_MANAGER_POLICY_STATIC,
    TOPOLOGY_MANAGER_POLICY_SINGLE_NUMA_POD,
    ZONE_TYPE_NODE,
    zones_from_json,
)
from ..topology.plugin import ERR_FAILED_TO_GET_NRT, ERR_NUMA_INSUFFICIENT
from .types import Resource

__all__ = ["DripColumns", "GangColumns", "ZoneColumns"]

_I64_MIN = np.int64(np.iinfo(np.int64).min)

# distinct request shapes worth keeping incremental trees for; beyond
# this the per-fold maintenance would outweigh the argmax it replaces
_MAX_TREES = 8


class DripColumns:
    """Owns the cached Filter/Score columns for one ``Scheduler``.

    Not thread-safe — same single-loop contract as the Scheduler that
    owns it (concurrent cluster writers are detected via the version keys
    and trigger rebuilds, never torn reads: the private store is only ever
    written by ``ensure`` on the scheduling thread).
    """

    # metric family names — subclasses (GangColumns) rename the whole
    # family set while sharing every cache and journal mechanism
    _HITS_METRIC = (
        "crane_drip_column_hits_total",
        "schedule_one calls served entirely from cached columns",
    )
    _REBUILDS_METRIC = (
        "crane_drip_column_rebuilds_total",
        "Drip column rebuilds by column family",
    )
    _DIRTY_CONSUMER = "drip"

    # scatter-log entries kept for the device column cache
    _SCATTER_LOG_CAP = 64

    def __init__(
        self,
        cluster,
        dyn=None,
        dyn_weight: int = 1,
        order=("dyn",),
        fit_tracker=None,
        telemetry=None,
        bucket_seconds: float = 0.25,
        policy=None,
        topology=None,
    ):
        """``policy`` is the plugin-less alternative to ``dyn``: a caller
        holding a ``DynamicSchedulerPolicy`` but no plugin instance (the
        gang engine: ``BatchScheduler`` has no plugin registry) passes it
        directly; exactly one of the two must be given. ``topology``: the
        ``TopologyMatch`` plugin whose zone columns the NRT drip window
        reads (``zones``, a ``ZoneColumns``), or None."""
        self.cluster = cluster
        self._dyn = dyn
        self._dyn_weight = int(dyn_weight)
        # Filter evaluation order ("fit" / "dyn"), registration order —
        # reconstructing the scalar loop's first-failing-plugin reason
        # depends on it
        self._order = tuple(order)
        self._tracker = fit_tracker
        self._telemetry = telemetry
        self._tensors = compile_policy(dyn.policy if policy is None else policy)
        self._store = NodeLoadStore(self._tensors)
        self._bucket_s = float(bucket_seconds)

        # snapshot-order node names; identity is a cache key for the
        # tracker's aligned-row gather, so the list object is only
        # replaced when membership/order actually changes
        self.names: list[str] = []
        self._names_set: set[str] = set()
        self._pos: dict[str, int] | None = None  # name -> row (lazy)
        self._node_ver = -1  # cluster.node_version the ingest reflects

        # dynamic columns (aligned with self.names)
        self._store_ver = -1
        self._bucket: int | None = None
        self._gather: tuple | None = None  # (layout_version, ids)
        self.schedulable: np.ndarray | None = None  # bool [N]
        self.fail_entry: np.ndarray | None = None  # int32 [N]
        self.score: np.ndarray | None = None  # int64 [N] raw (0..100)
        self.weighted: np.ndarray | None = None  # int64 [N]
        # dirty-journal bookkeeping: rows touched since the last dynamic
        # column build (None = coverage lost, the next build is full), and
        # a monotonically increasing column epoch with a bounded scatter
        # log, so the device column cache can scatter exactly the patched
        # rows instead of re-uploading (in-place patches keep array
        # identity; the epoch is the version identity cannot be)
        self._pending_rows: set[int] | None = set()
        self.col_epoch = 0
        self._scatter_log: list[tuple[int, np.ndarray]] = []  # (to_epoch, rows)

        # fit columns (aligned with self.names; free is OUR copy). Keyed on
        # the tracker's alloc_version, not node_version: an annotation
        # patch bumps the node fence but cannot change allocatable
        # capacity, so the O(n) free_matrix copy is skipped unless capacity
        # rows actually moved.
        self._fit_pod_ver = -1
        self._fit_node_ver = -1
        self._fit_alloc_ver = -1
        self._fit_names = None  # names list identity the fit rows align to
        self.bounded: np.ndarray | None = None  # bool [N]
        self.free: np.ndarray | None = None  # int64 [N, 4]

        # incremental first-argmax trees, one per distinct request vec
        # (scorer.topk.SegMaxTree): valid only for the exact column arrays
        # they were built over — identity-keyed, since rebuilds always
        # replace arrays (in-place dynamic patches re-read their rows)
        self._trees: dict[bytes, tuple] = {}
        self._trees_cols: tuple | None = None

        self.stats = {
            "hits": 0, "rebuilds": 0, "folds": 0, "drops": 0,
            "topk_builds": 0, "topk_updates": 0,
            "dirty_patches": 0, "dirty_rows": 0, "full_sweeps": 0,
        }
        self.zones = None if topology is None else ZoneColumns(cluster, topology)
        self._folds: _Folds | None = None  # the next NRT window's fold record
        self._m_hits = self._m_rebuilds = self._m_dirty_rows = None
        if telemetry is not None:
            reg = telemetry.registry
            self._m_hits = reg.counter(*self._HITS_METRIC)
            self._m_rebuilds = reg.counter(*self._REBUILDS_METRIC, ("column",))
            self._m_dirty_rows = reg.counter(
                "crane_dirty_rows_total",
                "Rows patched via the dirty-name journal instead of a "
                "full identity sweep, by consumer",
                ("consumer",),
            )

    # -- cache maintenance -------------------------------------------------

    def ensure(self, now: float) -> None:
        """Bring every column up to date for scheduling time ``now``.

        Named-write fast path: when the cluster's dirty-name journal
        covers the interval since the last ingest, only the dirty names'
        store rows re-parse and only their column rows recompute
        (scattered in place, logged for the device-side scatter): a 1-node
        annotation patch is O(1) work however large the cluster. Journal
        overruns, columnar sweeps, clock-bucket rolls and membership
        changes the journal cannot localize fall back to exactly one
        identity sweep (``full_sweeps``)."""
        rebuilt = False
        cluster = self.cluster
        nv = cluster.node_version
        if nv != self._node_ver:
            dirty = None
            if self.names and self._node_ver >= 0:
                dirty = cluster.dirty_nodes_since(self._node_ver)
            if dirty is not None and not self._apply_dirty(dirty, cluster):
                dirty = None
            if dirty is None:
                self._full_ingest(cluster)
            self._node_ver = nv
        bucket = int(now / self._bucket_s) if self._bucket_s > 0 else 0
        sv = self._store.version
        if self.weighted is None or sv != self._store_ver or bucket != self._bucket:
            pending = self._pending_rows
            incremental = (
                self.weighted is not None
                and bucket == self._bucket
                and pending is not None
                and self._gather is not None
                and self._gather[0] == self._store.layout_version
            )
            with maybe_span(self._telemetry, "drip_column_rebuild", column="dynamic"):
                if incremental:
                    self._patch_dynamic(pending, now)
                else:
                    self._rebuild_dynamic(now)
            self._pending_rows = set()
            self._store_ver = sv
            self._bucket = bucket
            rebuilt = True
            self.stats["rebuilds"] += 1
            if self._m_rebuilds is not None:
                self._m_rebuilds.labels(column="dynamic").inc()
        if self._tracker is not None:
            pv = cluster.pod_version
            stale = (
                self.free is None
                or pv != self._fit_pod_ver
                or nv != self._fit_node_ver
            )
            if stale:
                with maybe_span(self._telemetry, "drip_column_rebuild", column="fit"):
                    rebuilt = self._refresh_fit(pv, nv) or rebuilt
        if self.zones is not None:
            self.zones.ensure(self.names, self._pos_map())
        if not rebuilt:
            self.stats["hits"] += 1
            if self._m_hits is not None:
                self._m_hits.inc()

    def _refresh_fit(self, pv: int, nv: int) -> bool:
        """Refresh the tracker and, when capacity or bound pods moved, the
        aligned fit columns; returns whether they were rebuilt."""
        self._tracker.refresh()
        av = self._tracker.alloc_version
        if (
            self.free is not None
            and av == self._fit_alloc_ver
            and pv == self._fit_pod_ver
            and self._fit_names is self.names
        ):
            # capacity rows and bound-pod state are both unchanged (an
            # annotation patch moved the node fence): the aligned copies
            # are still exact
            self._fit_node_ver = nv
            return False
        self.bounded, self.free = self._tracker.free_matrix(self.names)
        self._fit_pod_ver = pv
        self._fit_node_ver = nv
        self._fit_alloc_ver = av
        self._fit_names = self.names
        self.stats["rebuilds"] += 1
        if self._m_rebuilds is not None:
            self._m_rebuilds.labels(column="fit").inc()
        return True

    def _full_ingest(self, cluster) -> None:
        """The identity sweep: list every node, identity-gate every row.
        Exactly one of these per uncovered journal interval."""
        nodes = cluster.list_nodes()
        names = [n.name for n in nodes]
        # identity-gated: unchanged annotation maps are skipped, so an
        # annotator sweep costs O(changed rows), not O(nodes)
        self._store.bulk_ingest((n.name, n.annotations) for n in nodes)
        if len(self._store) != len(names):
            self._store.prune_absent(names)
        if names != self.names:
            self.names = names
            self._names_set = set(names)
            self._pos = None
            self._gather = None
            self._fit_node_ver = -1  # fit rows must realign
            self._fit_names = None
        # charge the name->row map to the sweep (already O(n)), not to the
        # first O(dirty) patch that would otherwise build it lazily
        self._pos_map()
        self._pending_rows = None  # row set unknown: next build is full
        self.stats["full_sweeps"] += 1

    def _pos_map(self) -> dict[str, int]:
        pos = self._pos
        if pos is None:
            pos = self._pos = {n: i for i, n in enumerate(self.names)}
        return pos

    def _count_dirty_rows(self, n: int) -> None:
        self.stats["dirty_rows"] += n
        if self._m_dirty_rows is not None:
            self._m_dirty_rows.labels(consumer=self._DIRTY_CONSUMER).inc(n)

    def _apply_dirty(self, dirty, cluster) -> bool:
        """Consume a covered journal interval: re-ingest only the dirty
        names' rows (and, under a membership change, add or drop exactly
        the moved names). Returns False when the delta cannot be applied
        locally and the caller must run the identity sweep."""
        touched, membership = dirty
        if not touched:
            return True
        get_node = cluster.get_node
        names_set = self._names_set
        if not membership:
            items = []
            for nm in touched:
                if nm not in names_set:
                    continue
                node = get_node(nm)
                if node is None:
                    return False  # membership drifted without the flag
                items.append((nm, node.annotations))
            if items:
                self._note_dirty_rows(items)
            return True
        # membership delta: classify each touched name against the
        # cluster's current membership
        adds: list[str] = []
        removes: list[str] = []
        patch: list[str] = []
        for nm in touched:
            present = cluster.has_node(nm)
            if present and nm not in names_set:
                adds.append(nm)
            elif not present and nm in names_set:
                removes.append(nm)
            elif present:
                patch.append(nm)
        items = []
        for nm in adds + patch:
            node = get_node(nm)
            if node is None:
                return False
            items.append((nm, node.annotations))
        if not adds and not removes:
            if items:
                self._note_dirty_rows(items)
            return True
        for nm in removes:
            self._store.remove_node(nm)
        if items:
            self._store.bulk_ingest(items, skip_unchanged=False)
            self._count_dirty_rows(len(items))
        # splice the names list instead of a full relist: removals drop
        # their rows, additions append in sorted order
        rm = set(removes)
        names = [n for n in self.names if n not in rm]
        names.extend(sorted(adds))
        self.names = names
        self._names_set = set(names)
        self._pos = None
        self._pos_map()  # the splice is already O(n): prewarm the row map
        self._gather = None
        self._pending_rows = None  # row count changed: full column pass
        self.weighted = None
        self._fit_node_ver = -1
        self._fit_names = None
        return True

    def _note_dirty_rows(self, items) -> None:
        """Ingest dirty rows and queue their column positions for the
        incremental dynamic patch."""
        self._store.bulk_ingest(items)
        self._count_dirty_rows(len(items))
        pending = self._pending_rows
        if pending is not None:
            pos = self._pos_map()
            for nm, _ in items:
                pending.add(pos[nm])

    def _ensure_gather(self):
        store = self._store
        gather = self._gather
        lv = store.layout_version
        if gather is None or gather[0] != lv:
            node_id = store.node_id
            ids = np.fromiter(
                (node_id(nm) for nm in self.names), dtype=np.int64, count=len(self.names)
            )
            gather = self._gather = (lv, ids)
        return gather[1]

    def _rebuild_dynamic(self, now: float) -> None:
        store = self._store
        ids = self._ensure_gather()
        self.schedulable, self.fail_entry, score = drip_filter_score_columns(
            self._tensors,
            store.values[ids],
            store.ts[ids],
            store.hot_value[ids],
            store.hot_ts[ids],
            now,
        )
        self.score = score.astype(np.int64)
        self.weighted = self.score * self._dyn_weight
        # fresh arrays: identity changed and the device cache re-uploads
        # regardless, so the scatter chain restarts here
        self.col_epoch += 1
        self._scatter_log.clear()

    def _patch_dynamic(self, rows, now: float) -> None:
        """O(dirty) twin of ``_rebuild_dynamic``: recompute the column
        verdicts for ``rows`` only and scatter them into the existing
        arrays (identity kept; ``col_epoch`` and the scatter log carry the
        change to identity-keyed consumers). Clean rows keep their
        verdicts from the build that produced them; both evaluations share
        the clock bucket, the staleness the bucket contract already
        grants."""
        if not rows:
            self.col_epoch += 1
            self._scatter_log.append((self.col_epoch, np.empty((0,), dtype=np.int64)))
            self._trim_scatter_log()
            return
        store = self._store
        ids_all = self._ensure_gather()
        rows_arr = np.fromiter(rows, dtype=np.int64, count=len(rows))
        rows_arr.sort()
        ids = ids_all[rows_arr]
        sched, fail, score = drip_filter_score_columns(
            self._tensors,
            store.values[ids],
            store.ts[ids],
            store.hot_value[ids],
            store.hot_ts[ids],
            now,
        )
        self.schedulable[rows_arr] = sched
        self.fail_entry[rows_arr] = fail
        sc = score.astype(np.int64)
        self.score[rows_arr] = sc
        self.weighted[rows_arr] = sc * self._dyn_weight
        self.col_epoch += 1
        self._scatter_log.append((self.col_epoch, rows_arr))
        self._trim_scatter_log()
        # in-place writes are invisible to the identity-keyed trees:
        # re-read exactly the patched rows instead of dropping the trees
        # (a drop costs the next probe an O(n) rebuild per vec)
        if self._trees:
            self._patch_trees(rows_arr.tolist())
        self.stats["dirty_patches"] += 1

    def _trim_scatter_log(self) -> None:
        log = self._scatter_log
        if len(log) > self._SCATTER_LOG_CAP:
            del log[0]

    def dirty_rows_between(self, from_epoch: int, to_epoch: int):
        """Union of column rows patched in ``(from_epoch, to_epoch]``, or
        None when the scatter log no longer covers the interval (the
        device cache then re-uploads). Epochs are consecutive — one log
        entry per patch — so coverage is a simple chain check."""
        if from_epoch == to_epoch:
            return np.empty((0,), dtype=np.int64)
        log = self._scatter_log
        if not log or log[0][0] > from_epoch + 1:
            return None
        chunks = [r for e, r in log if from_epoch < e <= to_epoch]
        if len(chunks) != to_epoch - from_epoch:
            return None  # a full rebuild broke the chain
        if len(chunks) == 1:
            return chunks[0]
        return np.unique(np.concatenate(chunks))

    def note_bind(self, best_i: int, vec: np.ndarray, pre_pod: int, was_bound: bool) -> None:
        """Fold our own bind into the fit column (same discipline as
        ``Scheduler._note_bind``): valid only when pod_version moved
        exactly pre_pod -> pre_pod+1 by our bind and the pod was not
        re-placed; anything else drops the column for a rebuild."""
        if self._tracker is None or self.free is None:
            return
        if (
            was_bound
            or self._fit_pod_ver != pre_pod
            or self.cluster.pod_version != pre_pod + 1
        ):
            self.drop_fit()
            return
        self.fold_row(best_i, vec)
        self._fit_pod_ver = pre_pod + 1

    def fold_row(self, best_i: int, vec: np.ndarray) -> None:
        """Unchecked single fold. ``note_bind`` validates the version
        stamp per pod; the batch dispatch window validates pre ->
        pre+n_bound once and then replays the kernel's sequential folds row
        by row (so infeasible-pod reasons later in the window read the same
        free state the per-pod path would have)."""
        self.free[best_i] -= vec
        self.stats["folds"] += 1
        if self._trees:
            self._update_trees(best_i)

    def commit_folds(self, pod_ver: int) -> None:
        """Stamp the fit column after a batch window's folds."""
        self._fit_pod_ver = int(pod_ver)

    def drop_fit(self) -> None:
        """Invalidate the fit column (interleaved writer / re-placement /
        partial window bind) — the next ``ensure`` rebuilds from the
        tracker."""
        self.free = None
        self.bounded = None
        self._fit_pod_ver = -1
        self.stats["drops"] += 1
        self._trees.clear()

    def _patch_trees(self, rows) -> None:
        """O(dirty log n) per cached tree after an in-place dynamic patch.
        The fold path (``_update_trees``) only re-masks fit verdicts, but a
        dynamic patch moves schedulable and weighted too, so every tree —
        fit dimension or not — re-reads the patched rows."""
        for i in rows:
            sched_i = bool(self.schedulable[i])
            bnd_i = bool(self.bounded[i]) if self.bounded is not None else False
            w_i = int(self.weighted[i])
            free_i = self.free[i] if self.free is not None else None
            for tree, tvec in self._trees.values():
                feas = sched_i
                if feas and tvec is not None and bnd_i and free_i is not None:
                    feas = not bool(((tvec > 0) & (free_i < tvec)).any())
                tree.update(i, w_i, feas)
                self.stats["topk_updates"] += 1

    def _update_trees(self, best_i: int) -> None:
        """O(log n) per cached tree: re-mask only the folded row."""
        sched_i = bool(self.schedulable[best_i])
        bnd_i = bool(self.bounded[best_i]) if self.bounded is not None else False
        w_i = int(self.weighted[best_i])
        free_i = self.free[best_i] if self.free is not None else None
        for tree, tvec in self._trees.values():
            if tvec is None:
                continue  # no fit dimension in this tree's mask
            feas = sched_i and not (bnd_i and bool(((tvec > 0) & (free_i < tvec)).any()))
            tree.update(best_i, w_i, feas)
            self.stats["topk_updates"] += 1

    # -- per-pod reads -----------------------------------------------------

    def feasible_mask(self, vec: np.ndarray) -> np.ndarray:
        """Combined Filter verdict for a pod with request row ``vec``."""
        mask = self.schedulable
        if self._tracker is not None:
            fit_fail = self.bounded & ((vec > 0) & (self.free < vec)).any(axis=1)
            mask = mask & ~fit_fail
        return mask

    def mask_closure(self, vec: np.ndarray | None):
        """Lazy ``feasible_mask`` capturing the current column arrays:
        result closures may run after later folds or drops, and rebuilds
        replace arrays (never resize), so the captured objects always stay
        mutually aligned. The O(n) mask is paid only when read."""
        schedulable = self.schedulable
        bounded = self.bounded
        free = self.free
        has_fit = self._tracker is not None and vec is not None

        def _mask():
            m = schedulable
            if has_fit and bounded is not None and free is not None:
                m = m & ~(bounded & ((vec > 0) & (free < vec)).any(axis=1))
            return m

        return _mask

    def topk_for(self, vec: np.ndarray | None) -> SegMaxTree:
        """Incremental first-argmax tree for request row ``vec`` — O(n)
        vectorized build on first sight of a (columns, vec) pair, then
        O(log n) maintenance per fold. The tree reproduces every selection
        read bit-identically: first-max argmax, feasible count, tie count,
        r-th tie."""
        cols = (id(self.weighted), id(self.free))
        if self._trees_cols != cols:
            self._trees.clear()
            self._trees_cols = cols
        key = b"" if vec is None else vec.tobytes()
        ent = self._trees.get(key)
        if ent is not None:
            return ent[0]
        mask = self.feasible_mask(vec)
        values = np.where(mask, self.weighted, _I64_MIN)
        tree = SegMaxTree(values, mask)
        if len(self._trees) >= _MAX_TREES:
            self._trees.pop(next(iter(self._trees)))
        self._trees[key] = (
            tree, None if vec is None or self._tracker is None else vec.copy()
        )
        self.stats["topk_builds"] += 1
        return tree

    def reason_for(self, i: int, vec: np.ndarray, nrt_code: int = -1) -> str:
        """The scalar loop's Filter failure message for node row ``i`` —
        first failing plugin in registration order, exact wording.
        ``nrt_code``: the NRT verdict of the row (``nrt_codes``)."""
        name = self.names[i]
        for kind in self._order:
            if kind == "fit":
                if self.bounded is not None and self.bounded[i]:
                    reason = row_fail_reason(self.free[i], vec)
                    if reason:
                        return f"Node {name} fit failure: {reason}"
            elif kind == "nrt":
                if nrt_code >= 0:
                    return _NRT_REASONS[nrt_code]
            else:
                entry = int(self.fail_entry[i])
                if entry >= 0:
                    metric = fail_metric_name(self._tensors, entry)
                    return f"Load[{metric}] of node[{name}] is too high"
        return ""

    def reason_counts(self, mask: np.ndarray, vec: np.ndarray, nrt=None, free=None) -> dict:
        """Filter-reason histogram over infeasible nodes, in node-index
        order so dict insertion order matches the scalar loop: one
        ``rows_fail_codes`` pass over the infeasible fit rows plus the
        cached ``fail_entry`` column give each node's first-failing
        (plugin, code) pair with no per-row Python but the formatting.
        ``nrt``: the NRT verdict per node (``nrt_codes``); ``free``: the
        fit rows to read instead of the live column."""
        idx = np.flatnonzero(~mask)
        if idx.size == 0:
            return {}
        free = self.free if free is None else free
        entries = self.fail_entry[idx]
        has_fit = "fit" in self._order and self.bounded is not None and vec is not None
        if has_fit:
            fit_codes = rows_fail_codes(free[idx], vec)
            fit_codes[~self.bounded[idx]] = -1
        else:
            fit_codes = np.full((idx.size,), -1, dtype=np.int8)
        nrt_codes = (np.full((idx.size,), -1, dtype=np.int8) if nrt is None
                     else np.asarray(nrt)[idx])
        # first failing plugin in registration order, per node
        fails = {"dyn": (entries >= 0, 1), "fit": (fit_codes >= 0, 2),
                 "nrt": (nrt_codes >= 0, 3)}
        kinds = np.zeros(idx.size, dtype=np.int8)
        for kind in reversed(self._order):
            hit, code = fails[kind]
            kinds = np.where(hit, code, kinds)
        metric_table = fail_metric_names(self._tensors)
        fit_table = [fail_code_reason(c) for c in range(4)]
        names = self.names
        counts: dict[str, int] = {}
        for p in np.flatnonzero(kinds):
            i = int(idx[p])
            if kinds[p] == 1:
                reason = f"Load[{metric_table[int(entries[p])]}] of node[{names[i]}] is too high"
            elif kinds[p] == 2:
                reason = f"Node {names[i]} fit failure: {fit_table[int(fit_codes[p])]}"
            else:
                reason = _NRT_REASONS[int(nrt_codes[p])]
            counts[reason] = counts.get(reason, 0) + 1
        return counts

    # -- the NRT window's host side ----------------------------------------

    def nrt_codes(self, pod_row: np.ndarray, used: np.ndarray) -> np.ndarray:
        """The NRT Filter's verdict per node for a pod (``pod_row``,
        ``scorer.drip_batch.numa_pod_rows``) over zone usage ``used``: -1
        passes, else an index into ``_NRT_REASONS`` (no CR; an aware pod
        with no zone that holds it)."""
        z = self.zones
        codes = np.full(len(self.names), -1, dtype=np.int8)
        req = int(pod_row[0])
        if req <= 0:
            return codes
        codes[~z.has] = 0
        need_fit = z.act_naw if pod_row[1] > 0 else (z.active & bool(pod_row[2] > 0))
        fits = ((z.zkey - used) >= req).any(axis=1)
        codes[need_fit & ~fits] = 1
        return codes

    def nrt_code(self, i: int, pod_row: np.ndarray, used: np.ndarray) -> int:
        """``nrt_codes`` of row ``i`` alone."""
        z = self.zones
        req = int(pod_row[0])
        if req <= 0:
            return -1
        if not z.has[i]:
            return 0
        need_fit = bool(z.act_naw[i]) if pod_row[1] > 0 else bool(z.active[i] and pod_row[2] > 0)
        if need_fit and not bool(((z.zkey[i] - used[i]) >= req).any()):
            return 1
        return -1

    def open_folds(self) -> _Folds:
        """The record the next NRT window folds into (``_Folds``); a fresh
        one, ending the chain, once either column was replaced."""
        tail = self._folds
        if tail is None or tail.free is not self.free or tail.used is not self.zones.used:
            tail = self._folds = _Folds(self.free, self.zones.used)
        return tail

    def close_folds(self, folds: _Folds, rows, dfree, dused) -> None:
        """Record a window's folds, in bind order, and open the next
        record."""
        folds.rows, folds.dfree, folds.dused = rows, dfree, dused
        folds.next = self._folds = _Folds(self.free, self.zones.used)


# a zone past a node's own zones: sorts after every real one, never fits
_NO_ZONE = -(1 << 62)

# the NRT Filter's failures (topology.plugin), by ``DripColumns.nrt_codes``
_NRT_REASONS = (ERR_FAILED_TO_GET_NRT, ERR_NUMA_INSUFFICIENT)


@functools.lru_cache(maxsize=4096)
def _annotation_usage(raw: str) -> tuple:
    """``(name, milli-CPU, memory, ephemeral)`` of each Node-type zone of a
    topology-result annotation (``helper.get_pod_numa_node_result``), what
    ``NodeWrapper.add_pod`` adds to the zone of that name."""
    zones = zones_from_json(raw) or []
    return _zone_usage([z for z in zones if z.type == ZONE_TYPE_NODE])


def _zone_usage(zones) -> tuple:
    out = []
    for zone in zones:
        r = Resource()
        if zone.resources is not None:
            r.add(zone.resources.capacity or {})
        out.append((zone.name, r.milli_cpu, r.memory, r.ephemeral_storage))
    return tuple(out)


class _Folds:
    """One accepted NRT window's folds into the host columns ``free`` and
    ``used`` (``ZoneColumns.used``), in bind order: the rows, the request
    rows taken from ``free`` and the zone takes added to ``used``. ``next``
    is the following window's record, once it is opened. A result of the
    window reads the columns as its pod saw them by undoing every fold
    after its own place (``columns_at``)."""

    __slots__ = ("free", "used", "rows", "dfree", "dused", "next")

    def __init__(self, free, used):
        self.free, self.used = free, used
        self.rows = self.dfree = self.dused = self.next = None


def columns_at(folds: _Folds, j: int, free, used):
    """Copies of ``free`` and ``used`` as they were before fold ``j`` of
    ``folds``: every later fold on the same arrays undone (a record whose
    arrays were since replaced ends the chain, since replaced arrays are
    not written again)."""
    f = None if free is None else free.copy()
    u = used.copy()
    while folds is not None and folds.rows is not None and folds.used is used \
            and folds.free is free:
        rows = folds.rows[j:]
        if f is not None:
            np.add.at(f, rows, folds.dfree[j:])
        np.subtract.at(u, rows, folds.dused[j:])
        folds, j = folds.next, 0
    return f, u


class ZoneColumns:
    """Per-node NUMA zone columns of ``NodeResourceTopologyMatch`` for the
    batched drip window (``Scheduler.schedule_queue`` with the plugin;
    ``scorer.drip_batch._drip_batch_numa`` reads them).

    Static columns, from each node's NRT CR (``lister``), rebuilt when the
    lister's ``version`` or the node list moves and versioned by ``epoch``
    for the device column cache: ``has`` (a CR), ``active`` (its CPU
    manager policy is Static), ``act_naw`` (Static and single-NUMA pod
    level), ``zkey`` int64 [N, Z] (a zone's allocatable milli-CPU in CR
    order, ``_NO_ZONE`` past the node's zones) and ``zcap`` (the same
    floored to whole cores, 0 past them); ``zone_names`` with ``layout``
    [N] give each row's zone names in CR order (-1: no CR).

    ``used`` int64 [N, Z] is each zone's requested milli-CPU, rebuilt as
    the plugin's ``NodeWrapper.add_pod`` does: every bound pod's
    topology-result annotation, else its entry in the assume cache. It is
    keyed on the cluster's ``pod_version`` and the cache's versions: a
    write the pod journal covers re-reads only its nodes (the cache's
    additions show through the binds the journal records; a removal, or
    an uncovered interval, rebuilds every row), and the scheduler's own
    accepted windows fold their zone takes in place (``fold``) under the
    stamp discipline of the fit column. A rebuild or patch replaces the
    array, so a result's view of the columns at its pod (``_Folds``) stays
    exact.

    ``clean`` is False while a Static node has a zone whose memory or
    ephemeral storage is overcommitted by the results it holds, or a CR
    repeats a zone name: the window models milli-CPU only, so the
    scheduler then places its pods one by one."""

    def __init__(self, cluster, topology):
        self.cluster = cluster
        self.topology = topology
        self.names = None  # the node list the rows align to (identity)
        self.has = self.active = self.act_naw = None
        self.zkey = self.zcap = None
        self.used = None
        self.zone_names: list[tuple] = []
        self.layout = None
        self.epoch = 0
        self._other = None  # int64 [N, Z, 2] allocatable memory, ephemeral
        self._dup = None  # bool [N] a CR that repeats a zone name
        self._over = None  # bool [N] memory or ephemeral overcommitted
        self._lister_ver = self._pod_ver = self._cache_ver = self._shrink_ver = -1
        # (zone names, takes) -> (zone result, its annotation text)
        # (``Scheduler._zone_result``); cleared with the static columns
        self.results: dict = {}
        self.stats = {"zone_rebuilds": 0, "zone_rows": 0}

    @property
    def z(self) -> int:
        return int(self.zkey.shape[1])

    @property
    def clean(self) -> bool:
        return not bool(((self._over | self._dup) & self.active).any())

    def ensure(self, names: list, pos: dict) -> None:
        """Bring the columns up to date for the node list ``names``."""
        topo = self.topology
        lv = topo.lister.version
        pv = self.cluster.pod_version
        cache = topo.cache
        cv, sv = cache.version, cache.shrink_version
        if names is not self.names or lv != self._lister_ver:
            self._rebuild_crs(names)
            self._rebuild_used()
        elif pv != self._pod_ver or cv != self._cache_ver or sv != self._shrink_ver:
            changed = None
            if sv == self._shrink_ver:
                changed = self.cluster.pod_changes_since(self._pod_ver)
            if changed is None:
                self._rebuild_used()
            else:
                self._patch_used(sorted(pos[nm] for nm in changed if nm in pos))
        self._lister_ver, self._pod_ver, self._cache_ver, self._shrink_ver = lv, pv, cv, sv

    def _rebuild_crs(self, names: list) -> None:
        get = self.topology.lister.get
        crs = []
        for name in names:
            try:
                crs.append(get(name))
            except KeyError:
                crs.append(None)
        n = len(names)
        z = max([len(c.zones) for c in crs if c is not None], default=0) or 1
        zkey = np.full((n, z), _NO_ZONE, np.int64)
        zcap = np.zeros((n, z), np.int64)
        other = np.zeros((n, z, 2), np.int64)
        layout = np.full(n, -1, np.int32)
        has = np.zeros(n, bool)
        active = np.zeros(n, bool)
        naw = np.zeros(n, bool)
        dup = np.zeros(n, bool)
        parsed: dict = {}  # id(zones) -> (layout index, alloc rows); zones held by crs
        self.zone_names = []
        for i, cr in enumerate(crs):
            if cr is None:
                continue
            has[i] = True
            policy = cr.crane_manager_policy
            active[i] = policy.cpu_manager_policy == CPU_MANAGER_POLICY_STATIC
            naw[i] = policy.topology_manager_policy == TOPOLOGY_MANAGER_POLICY_SINGLE_NUMA_POD
            hit = parsed.get(id(cr.zones))
            if hit is None:
                allocs = []
                for zone in cr.zones:
                    r = Resource()
                    r.add((zone.resources.allocatable if zone.resources else {}) or {})
                    allocs.append((r.milli_cpu, r.memory, r.ephemeral_storage))
                zn = tuple(zone.name for zone in cr.zones)
                self.zone_names.append(zn)
                hit = parsed[id(cr.zones)] = (len(self.zone_names) - 1, allocs,
                                              len(set(zn)) != len(zn))
            li, allocs, repeated = hit
            layout[i] = li
            dup[i] = repeated
            for j, (cpu, mem, eph) in enumerate(allocs):
                zkey[i, j] = cpu
                zcap[i, j] = cpu // 1000 * 1000  # whole cores (helper.go:194)
                other[i, j] = (mem, eph)
        self.names = names
        self.has, self.active, self.act_naw = has, active, active & naw
        self.zkey, self.zcap, self._other = zkey, zcap, other
        self.layout, self._dup = layout, dup
        self.results = {}
        self.epoch += 1

    def _rows_usage(self, rows, pods_of) -> None:
        """Recompute ``used`` and the overcommit flag of ``rows`` (in
        place; the caller has replaced the arrays)."""
        cache = self.topology.cache
        for i in rows:
            li = int(self.layout[i])
            if li < 0:
                self.used[i] = 0
                self._over[i] = False
                continue
            znames = self.zone_names[li]
            acc = np.zeros((self.z, 3), np.int64)
            for pod in pods_of(self.names[i]):
                raw = (pod.annotations or {}).get(ANNOTATION_POD_TOPOLOGY_RESULT)
                usage = _annotation_usage(raw) if isinstance(raw, str) else ()
                if not usage:
                    try:
                        usage = _zone_usage(cache.get_pod_topology(pod))
                    except KeyError:
                        continue
                for name, cpu, mem, eph in usage:
                    for j, zn in enumerate(znames):
                        if zn == name:
                            acc[j] += (cpu, mem, eph)
            self.used[i] = acc[:, 0]
            self._over[i] = bool((acc[:, 1:] > self._other[i]).any())
        self.stats["zone_rows"] += len(rows)

    def _rebuild_used(self) -> None:
        n = len(self.names)
        by_node: dict = {}
        for pod in self.cluster.list_pods():
            if pod.node_name:
                by_node.setdefault(pod.node_name, []).append(pod)
        self.used = np.zeros((n, self.z), np.int64)
        self._over = np.zeros(n, bool)
        rows = [i for i, nm in enumerate(self.names) if nm in by_node]
        self._rows_usage(rows, lambda nm: by_node[nm])
        self.stats["zone_rebuilds"] += 1

    def _patch_used(self, rows) -> None:
        if not rows:
            return
        self.used = self.used.copy()
        self._over = self._over.copy()
        self._rows_usage(rows, self.cluster.list_pods)

    def fold(self, row: int, take: np.ndarray) -> None:
        """One accepted bind's zone takes (unchecked; the window validates
        the stamps once, as for the fit column)."""
        self.used[row] += take

    def commit(self, pod_ver: int, cache_ver: int) -> None:
        """Stamp the columns after a window's folds: the cluster and the
        cache moved by the window's own binds and assumes alone."""
        self._pod_ver, self._cache_ver = int(pod_ver), int(cache_ver)

    def stamps(self) -> tuple:
        return self._pod_ver, self._cache_ver


class GangColumns(DripColumns):
    """The gang engine's column cache: every ``DripColumns`` mechanism —
    version fences, dirty-name journal patches, fit fold discipline, the
    col_epoch scatter log — under the gang path's own metric families,
    plus a per-node accelerator-type column for heterogeneous queues.

    The accel column interns each node's ``labels[accel_label]`` value to
    a small integer id (``accel_types`` is the id -> label table; id 0 is
    the untyped default). It is keyed on ``cluster.node_version`` like the
    dynamic ingest and patched O(dirty) through the same journal: a label
    change on one node re-reads one row. Per-accelerator throughput
    weights resolve against this column into per-class score offsets;
    ``accel_epoch`` versions the column for the engine's offset-row
    cache."""

    _HITS_METRIC = (
        "crane_gang_column_hits_total",
        "Gang dispatch windows served entirely from cached columns",
    )
    _REBUILDS_METRIC = (
        "crane_gang_column_rebuilds_total",
        "Gang column rebuilds by column family",
    )
    _DIRTY_CONSUMER = "gang"

    def __init__(self, *args, accel_label: str | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self._accel_label = accel_label
        self.accel_types: list[str] = [""]  # id 0 = untyped
        self._accel_index: dict[str, int] = {"": 0}
        self.accel: np.ndarray | None = None  # int32 [N] type ids
        self._accel_names = None  # names list identity the column aligns to
        self._accel_node_ver = -1
        self.accel_epoch = 0

    def _accel_type_id(self, node) -> int:
        labels = getattr(node, "labels", None) if node is not None else None
        label = (labels or {}).get(self._accel_label or "", "")
        idx = self._accel_index.get(label)
        if idx is None:
            idx = len(self.accel_types)
            self.accel_types.append(label)
            self._accel_index[label] = idx
        return idx

    def ensure_accel(self) -> np.ndarray:
        """Bring the accelerator-type column up to date (call after
        ``ensure`` so ``names`` reflects current membership). Journal-
        covered label writes patch O(dirty) rows; membership changes or
        journal overruns rebuild the column in one sweep."""
        cluster = self.cluster
        nv = cluster.node_version
        aligned = self.accel is not None and self._accel_names is self.names
        if aligned and nv == self._accel_node_ver:
            return self.accel
        if aligned and self._accel_node_ver >= 0:
            d = cluster.dirty_nodes_since(self._accel_node_ver)
            if d is not None and not d[1]:  # covered, membership intact
                pos = self._pos_map()
                changed = False
                for nm in d[0]:
                    i = pos.get(nm)
                    if i is None:
                        continue
                    t = self._accel_type_id(cluster.get_node(nm))
                    if t != self.accel[i]:
                        self.accel[i] = t
                        changed = True
                if changed:
                    self.accel_epoch += 1
                self._accel_node_ver = nv
                return self.accel
        n = len(self.names)
        if self._accel_label is None:
            accel = np.zeros((n,), dtype=np.int32)  # all untyped
        else:
            get_node = cluster.get_node
            accel = np.fromiter(
                (self._accel_type_id(get_node(nm)) for nm in self.names),
                dtype=np.int32,
                count=n,
            )
        self.accel = accel
        self._accel_names = self.names
        self._accel_node_ver = nv
        self.accel_epoch += 1
        if self._m_rebuilds is not None:
            self._m_rebuilds.labels(column="accel").inc()
        return accel
