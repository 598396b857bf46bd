"""Columnar node-load state: the HBM-resident node-by-metric tensor.

Copy of ``crane_scheduler_tpu/loadstore/store.py``; annotation batches
decode through the host library's ``native.codec.bulk_parse_annotations``
(the numpy ``codec.bulk_decode_annotations`` for a zone with DST). With
the version and layout bookkeeping that lets a resident device snapshot
follow the store by row deltas (``delta_since``) or by replaying
whole-column writes (``column_delta_since``, fed by ``bulk_set_by_name``,
the annotator's direct-mode sweep shape), and ``ingest_annotation_columns``,
the columnar ingest that the kube mirror's decoded LIST columns feed.

The reference's scoring inputs live as per-node annotation strings patched
one (node, metric) at a time (ref: pkg/controller/annotator/node.go:123-146)
and re-parsed per scheduling cycle (ref: pkg/plugins/dynamic/stats.go:51-76).
Here the same state is columnar: ``value[node, metric]`` and
``timestamp[node, metric]`` float64 matrices plus ``hot_value[node]`` /
``hot_ts[node]`` vectors, refreshed in bulk and uploaded to device as one
padded snapshot. Encoding:

- missing / structurally-invalid annotation -> ``ts = -inf`` (never fresh,
  so every reader takes the fail-open path, exactly like a parse error);
- a value string that parsed to NaN stays NaN with its real timestamp
  (Go lets NaN through the ``< 0`` check; we preserve that).

Padding discipline: snapshots round the node axis up to a bucket size so
device shapes stay stable as the cluster grows (the kernels' grids and
the step's buffers keep one size at 50k nodes); padded rows carry
``node_valid = False``.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass
from typing import Mapping

import numpy as np

from ..constants import NODE_HOT_VALUE_KEY
from ..policy.compile import PolicyTensors
from .codec import decode_annotation_or_missing

_NEG_INF = float("-inf")


def _locked(fn):
    """Run the method under the store's reentrant mutation lock."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)

    return wrapper


def _pad_bucket(n: int, bucket: int) -> int:
    if n <= 0:
        return bucket
    return ((n + bucket - 1) // bucket) * bucket


@dataclass(frozen=True)
class DeviceSnapshot:
    """A device-ready view of the store (numpy; the step uploads it)."""

    values: np.ndarray  # [Npad, M] f64
    ts: np.ndarray  # [Npad, M] f64 epoch seconds, -inf = missing
    hot_value: np.ndarray  # [Npad] f64
    hot_ts: np.ndarray  # [Npad] f64
    node_valid: np.ndarray  # [Npad] bool
    n_nodes: int
    node_names: tuple[str, ...]
    # store version and layout version the snapshot was taken at, read
    # under the same lock hold as the data (-1 = synthetic snapshot): the
    # resident device copy keys on both
    version: int = -1
    layout_version: int = -1


class NodeLoadStore:
    """Mutable host-side store with amortized growth and bulk refresh."""

    def __init__(self, tensors: PolicyTensors, initial_capacity: int = 64):
        self.tensors = tensors
        # Guards every mutation and snapshot(): a refresh on one thread may
        # grow the arrays while another thread snapshots. Reentrant
        # because the bulk paths call add_node/remove_node internally.
        self._lock = threading.RLock()
        m = tensors.num_metrics
        cap = max(initial_capacity, 1)
        self._cap = cap
        self._n = 0
        self._names: list[str] = []
        self._index: dict[str, int] = {}
        self.values = np.full((cap, m), np.nan, dtype=np.float64)
        self.ts = np.full((cap, m), _NEG_INF, dtype=np.float64)
        self.hot_value = np.full((cap,), np.nan, dtype=np.float64)
        self.hot_ts = np.full((cap,), _NEG_INF, dtype=np.float64)
        # per-node annotation-map identity for skip-unchanged refreshes
        self._last_anno: dict[str, object] = {}
        # monotonic mutation counter: the scheduler's resident device
        # snapshot keys on this, so an unchanged store costs zero
        # host->device traffic per cycle
        self._version = 0
        # delta-upload support: which version last touched each row, and
        # a separate counter for layout changes (row <-> name mapping) —
        # value edits can upload as row deltas, layout changes cannot
        self._row_versions = np.zeros((cap,), dtype=np.int64)
        self._layout_version = 0
        # column-write log (see _COLUMN_LOG_CAP): entries
        # (pre_version, post_version, col_or_None, ids, values_or_None,
        #  ts_or_None, hot_values_or_None, hot_ts_or_None). A consumer
        # needs a contiguous pre/post chain from its version to the
        # current one: any other mutation breaks the chain by
        # construction, so no invalidation hooks are needed.
        self._column_log: list[tuple] = []
        # (names list identity, layout_version, ids): bulk_set_by_name's
        # name->row resolution for the annotator's cached sweep list
        self._ids_cache: tuple | None = None

    # bulk_set_by_name appends one entry per call so a device snapshot can
    # replay whole-column writes instead of re-uploading full matrices
    _COLUMN_LOG_CAP = 128

    @property
    def version(self) -> int:
        """Bumped by every mutation that can change snapshot contents."""
        return self._version

    @property
    def layout_version(self) -> int:
        """Bumped when the row <-> node-name mapping changes (add/remove);
        a device-resident snapshot can only delta-update while this is
        stable."""
        return self._layout_version

    def _touch(self, row: int) -> None:
        """Record that ``row`` changed at the current version (callers
        hold the lock and have already bumped ``_version``)."""
        self._row_versions[row] = self._version

    @_locked
    def column_delta_since(self, version: int):
        """Column-write replay from ``version`` to the current version:
        ``(current_version, layout_version, entries)`` where each entry is
        ``(col_or_None, ids, values_or_None, ts_or_None,
        hot_values_or_None, hot_ts_or_None)`` in application order, or
        ``None`` when the interval is not exactly covered by logged
        ``bulk_set_by_name`` calls."""
        if version == self._version:
            return self._version, self._layout_version, []
        start = None
        for k, entry in enumerate(self._column_log):
            if entry[0] == version:
                start = k
                break
        if start is None:
            return None
        chain = []
        expect = version
        for entry in self._column_log[start:]:
            if entry[0] != expect:
                return None
            chain.append(entry[2:])
            expect = entry[1]
        if expect != self._version:
            return None
        return self._version, self._layout_version, chain

    @_locked
    def delta_since(self, version: int):
        """Rows whose contents changed after ``version``, with their
        current data, all under one lock hold: ``(current_version,
        layout_version, row_ids, values[k, M], ts[k, M], hot_value[k],
        hot_ts[k])``. Valid for delta-uploading a device snapshot taken at
        ``version`` only while the layout version is unchanged (the caller
        checks). The arrays are fresh copies."""
        ids = np.nonzero(self._row_versions[: self._n] > version)[0].astype(np.int64)
        return (
            self._version,
            self._layout_version,
            ids,
            self.values[ids],
            self.ts[ids],
            self.hot_value[ids],
            self.hot_ts[ids],
        )

    # -- node membership ---------------------------------------------------

    def __len__(self) -> int:
        return self._n

    def node_id(self, name: str) -> int:
        return self._index[name]

    @property
    def node_names(self) -> tuple[str, ...]:
        return tuple(self._names)

    @_locked
    def add_node(self, name: str) -> int:
        if name in self._index:
            return self._index[name]
        if self._n == self._cap:
            self._grow(self._cap * 2)
        i = self._n
        self._n += 1
        self._names.append(name)
        self._index[name] = i
        self.values[i, :] = np.nan
        self.ts[i, :] = _NEG_INF
        self.hot_value[i] = np.nan
        self.hot_ts[i] = _NEG_INF
        self._version += 1
        self._layout_version += 1
        self._touch(i)
        return i

    @_locked
    def remove_node(self, name: str) -> None:
        """Swap-remove; row order is not part of the contract."""
        i = self._index.pop(name, None)
        self._last_anno.pop(name, None)
        if i is None:
            return
        last = self._n - 1
        if i != last:
            last_name = self._names[last]
            self.values[i] = self.values[last]
            self.ts[i] = self.ts[last]
            self.hot_value[i] = self.hot_value[last]
            self.hot_ts[i] = self.hot_ts[last]
            self._names[i] = last_name
            self._index[last_name] = i
        self._names.pop()
        self._n = last
        self._version += 1
        self._layout_version += 1
        self._row_versions[last] = 0
        if i != last:
            self._touch(i)  # row i now holds the moved node's data

    def _grow(self, new_cap: int) -> None:
        m = self.tensors.num_metrics
        for attr, fill, shape in (
            ("values", np.nan, (new_cap, m)),
            ("ts", _NEG_INF, (new_cap, m)),
            ("hot_value", np.nan, (new_cap,)),
            ("hot_ts", _NEG_INF, (new_cap,)),
            ("_row_versions", 0, (new_cap,)),
        ):
            old = getattr(self, attr)
            new = np.full(shape, fill, dtype=old.dtype)
            new[: self._n] = old[: self._n]
            setattr(self, attr, new)
        self._cap = new_cap

    # -- writes ------------------------------------------------------------

    @_locked
    def set_metric(
        self, node: str, metric: str, value: float, ts: float,
        create: bool = True,
    ) -> None:
        """One (node, metric) write. ``create=False`` drops the write when
        the node has no row (a writer racing ``prune_absent`` must not
        resurrect a deleted node)."""
        i = self._index.get(node)
        if i is None:
            if not create:
                return
            i = self.add_node(node)
        self._last_anno.pop(node, None)
        col = self.tensors.metric_index.get(metric)
        if col is None:
            return  # metric not referenced by the policy: ignore
        self.values[i, col] = value
        self.ts[i, col] = ts
        self._version += 1
        self._touch(i)

    @_locked
    def set_hot_value(
        self, node: str, value: float, ts: float, create: bool = True
    ) -> None:
        i = self._index.get(node)
        if i is None:
            if not create:
                return
            i = self.add_node(node)
        self._last_anno.pop(node, None)
        self.hot_value[i] = value
        self.hot_ts[i] = ts
        self._version += 1
        self._touch(i)

    @_locked
    def bulk_set_by_name(
        self,
        metric: str,
        names: list[str],
        values: np.ndarray,
        ts: float | np.ndarray,
        hot_values: np.ndarray | None = None,
        hot_ts: float | np.ndarray | None = None,
    ) -> None:
        """Atomic by-name column write: name->row resolution (adding
        missing nodes) and the metric/hot writes happen under one lock
        hold, so a concurrent ``prune_absent`` can never redirect a
        resolved id to another node's row. A write that kept the layout
        is logged for ``column_delta_since``."""
        index = self._index
        pre_version = self._version
        pre_layout = self._layout_version
        # a sweep passes the same cached name list once per metric:
        # resolve name->row once per (list identity, layout)
        cached = self._ids_cache
        if cached is not None and cached[0] is names and cached[1] == pre_layout:
            ids = cached[2]
        else:
            ids = np.asarray(
                [i if (i := index.get(n)) is not None else self.add_node(n) for n in names],
                dtype=np.int64,
            )
            if isinstance(names, list):
                self._ids_cache = (names, self._layout_version, ids)
        wrote = False
        col = self.tensors.metric_index.get(metric)
        if col is not None and len(ids):
            self.values[ids, col] = values
            self.ts[ids, col] = ts
            self._version += 1
            wrote = True
        if hot_values is not None and len(ids):
            self.hot_value[ids] = hot_values
            self.hot_ts[ids] = hot_ts
            self._version += 1
            wrote = True
        if not wrote:
            return
        self._row_versions[ids] = self._version
        if pre_layout != self._layout_version:
            return  # the write added nodes: not replayable

        def column(a):
            return np.broadcast_to(np.asarray(a, np.float64), ids.shape).copy()

        self._column_log.append((
            pre_version,
            self._version,
            col,
            ids,
            column(values) if col is not None else None,
            column(ts) if col is not None else None,
            column(hot_values) if hot_values is not None else None,
            column(hot_ts) if hot_values is not None else None,
        ))
        if len(self._column_log) > self._COLUMN_LOG_CAP:
            del self._column_log[0]

    def ingest_annotation(self, node: str, key: str, raw: str) -> None:
        """Decode one ``"value,timestamp"`` annotation into the store (the
        annotator's direct-mode backfill write)."""
        value, ts = decode_annotation_or_missing(raw)
        if key == NODE_HOT_VALUE_KEY:
            self.set_hot_value(node, value, ts)
        else:
            self.set_metric(node, key, value, ts)

    @_locked
    def ingest_node_annotations(self, node: str, anno: Mapping[str, str] | None) -> None:
        """Ingest one node's full annotation map (the parity read path):
        ``add_node`` then ``bulk_ingest([(node, anno)])`` without the
        identity skip, with the reference's version bookkeeping."""
        self.add_node(node)
        self._last_anno.pop(node, None)
        self.bulk_ingest([(node, anno)])
        # a later bulk_ingest must re-read the node whatever map it brings
        self._last_anno.pop(node, None)

    @_locked
    def prune_absent(self, live_names) -> int:
        """Remove rows for nodes not in ``live_names``; returns count."""
        live = set(live_names)
        stale = [n for n in self._names if n not in live]
        for name in stale:
            self.remove_node(name)
        return len(stale)

    @_locked
    def bulk_ingest(self, items, skip_unchanged: bool = True) -> None:
        """Ingest many (node_name, annotation_map) pairs with one batch
        parse call. Each map is authoritative for its node: keys absent
        from it are cleared, so a deleted annotation doesn't linger as
        live metric state. With ``skip_unchanged`` (the default), a node
        whose annotation map is the *same object* as last time is skipped
        — the cluster model replaces the map on every patch, so identity
        works like an informer's resourceVersion check and steady-state
        refreshes are O(changed).
        """
        index = self._index
        last = self._last_anno
        metric_get = self.tensors.metric_index.get
        raws: list[str] = []
        rows: list[int] = []
        cols: list[int] = []  # -1 == hot value
        touched: list[int] = []
        added = False
        for name, anno in items:
            i = index.get(name)
            if i is None:
                # batch-shaped add_node: one version bump for the call
                if self._n == self._cap:
                    self._grow(self._cap * 2)
                i = self._n
                self._n += 1
                self._names.append(name)
                index[name] = i
                added = True
            elif skip_unchanged and last.get(name) is anno:
                continue
            last[name] = anno
            touched.append(i)
            for key, raw in (anno or {}).items():
                col = -1 if key == NODE_HOT_VALUE_KEY else metric_get(key)
                if col is not None:
                    raws.append(raw)
                    rows.append(i)
                    cols.append(col)
        self._finish_ingest_locked(touched, raws, rows, cols, added)

    def _finish_ingest_locked(self, touched, raws, rows, cols, added: bool) -> None:
        """Shared tail of the bulk ingest paths: one version and layout
        bump, one fancy-indexed row reset, one batch decode, scattered
        metric and hot writes (callers hold the lock)."""
        if not touched:
            return
        self._version += 1
        if added:
            self._layout_version += 1
        t_idx = np.asarray(touched, dtype=np.int64)
        self.values[t_idx] = np.nan
        self.ts[t_idx] = _NEG_INF
        self.hot_value[t_idx] = np.nan
        self.hot_ts[t_idx] = _NEG_INF
        self._row_versions[t_idx] = self._version
        if not raws:
            return
        from ..native.codec import bulk_parse_annotations

        values, ts = bulk_parse_annotations(raws)
        rows_arr = np.asarray(rows, dtype=np.int64)
        cols_arr = np.asarray(cols, dtype=np.int64)
        metric = cols_arr >= 0
        self.values[rows_arr[metric], cols_arr[metric]] = values[metric]
        self.ts[rows_arr[metric], cols_arr[metric]] = ts[metric]
        self.hot_value[rows_arr[~metric]] = values[~metric]
        self.hot_ts[rows_arr[~metric]] = ts[~metric]

    @_locked
    def ingest_annotation_columns(self, names, keys, values, offsets,
                                  only_names=None) -> None:
        """Columnar twin of ``bulk_ingest``: per-node annotation maps
        arrive as flat aligned key/value columns (row ``i`` owns
        ``keys[offsets[i]:offsets[i+1]]``, the LIST decoder's shape), so a
        relist-sized refresh needs no per-node dict or Node object. Each
        row is authoritative for its node. There is no identity skip:
        callers gate on the cluster version, as
        ``BatchScheduler.refresh`` does. ``only_names`` narrows the write
        to a dirty subset; rows of other names are ignored."""
        index = self._index
        metric_get = self.tensors.metric_index.get
        raws: list = []
        rows: list[int] = []
        cols: list[int] = []  # -1 == hot value
        touched: list[int] = []
        added = False
        off = offsets.tolist() if hasattr(offsets, "tolist") else list(offsets)
        last = self._last_anno
        for j, name in enumerate(names):
            if only_names is not None and name not in only_names:
                continue
            i = index.get(name)
            if i is None:
                if self._n == self._cap:
                    self._grow(self._cap * 2)
                i = self._n
                self._n += 1
                self._names.append(name)
                index[name] = i
                added = True
            else:
                last.pop(name, None)
            touched.append(i)
            for k in range(off[j], off[j + 1]):
                key = keys[k]
                col = -1 if key == NODE_HOT_VALUE_KEY else metric_get(key)
                if col is not None:
                    raws.append(values[k])
                    rows.append(i)
                    cols.append(col)
        self._finish_ingest_locked(touched, raws, rows, cols, added)

    # -- snapshot ----------------------------------------------------------

    @_locked
    def snapshot(self, bucket: int = 2048) -> DeviceSnapshot:
        n = self._n
        npad = _pad_bucket(n, bucket)
        m = self.tensors.num_metrics
        values = np.full((npad, m), np.nan, dtype=np.float64)
        ts = np.full((npad, m), _NEG_INF, dtype=np.float64)
        hot_value = np.zeros((npad,), dtype=np.float64)
        hot_ts = np.full((npad,), _NEG_INF, dtype=np.float64)
        values[:n] = self.values[:n]
        ts[:n] = self.ts[:n]
        hot_value[:n] = self.hot_value[:n]
        hot_ts[:n] = self.hot_ts[:n]
        node_valid = np.zeros((npad,), dtype=bool)
        node_valid[:n] = True
        return DeviceSnapshot(
            values=values,
            ts=ts,
            hot_value=hot_value,
            hot_ts=hot_ts,
            node_valid=node_valid,
            n_nodes=n,
            node_names=tuple(self._names),
            version=self._version,
            layout_version=self._layout_version,
        )
