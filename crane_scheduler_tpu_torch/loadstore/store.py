"""Columnar node-load state: the HBM-resident node-by-metric tensor.

Copy of ``crane_scheduler_tpu/loadstore/store.py``; annotation batches
decode through ``codec.bulk_decode_annotations`` (the numpy codec).

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
from .codec import bulk_decode_annotations

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
    # store version the snapshot was taken at (-1 = synthetic snapshot):
    # the resident device copy keys on this
    version: int = -1


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

    @property
    def version(self) -> int:
        """Bumped by every mutation that can change snapshot contents."""
        return self._version

    # -- node membership ---------------------------------------------------

    def __len__(self) -> int:
        return self._n

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

    def _grow(self, new_cap: int) -> None:
        m = self.tensors.num_metrics
        for attr, fill, shape in (
            ("values", np.nan, (new_cap, m)),
            ("ts", _NEG_INF, (new_cap, m)),
            ("hot_value", np.nan, (new_cap,)),
            ("hot_ts", _NEG_INF, (new_cap,)),
        ):
            old = getattr(self, attr)
            new = np.full(shape, fill, dtype=old.dtype)
            new[: self._n] = old[: self._n]
            setattr(self, attr, new)
        self._cap = new_cap

    # -- writes ------------------------------------------------------------

    @_locked
    def ingest_node_annotations(self, node: str, anno: Mapping[str, str] | None) -> None:
        """Ingest one node's full annotation map (the parity read path):
        exactly ``bulk_ingest([(node, anno)])`` without the identity
        skip."""
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
    def bulk_ingest(self, items) -> None:
        """Ingest many (node_name, annotation_map) pairs with one batch
        parse call. Each map is authoritative for its node: keys absent
        from it are cleared, so a deleted annotation doesn't linger as
        live metric state. A node whose annotation map is the *same
        object* as last time is skipped — the cluster model replaces the
        map on every patch, so identity works like an informer's
        resourceVersion check and steady-state refreshes are O(changed).
        """
        index = self._index
        last = self._last_anno
        metric_get = self.tensors.metric_index.get
        raws: list[str] = []
        rows: list[int] = []
        cols: list[int] = []  # -1 == hot value
        touched: list[int] = []
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
            elif last.get(name) is anno:
                continue
            last[name] = anno
            touched.append(i)
            for key, raw in (anno or {}).items():
                col = -1 if key == NODE_HOT_VALUE_KEY else metric_get(key)
                if col is not None:
                    raws.append(raw)
                    rows.append(i)
                    cols.append(col)
        if not touched:
            return
        self._version += 1
        t_idx = np.asarray(touched, dtype=np.int64)
        self.values[t_idx] = np.nan
        self.ts[t_idx] = _NEG_INF
        self.hot_value[t_idx] = np.nan
        self.hot_ts[t_idx] = _NEG_INF
        if not raws:
            return
        values, ts = bulk_decode_annotations(raws)
        rows_arr = np.asarray(rows, dtype=np.int64)
        cols_arr = np.asarray(cols, dtype=np.int64)
        metric = cols_arr >= 0
        self.values[rows_arr[metric], cols_arr[metric]] = values[metric]
        self.ts[rows_arr[metric], cols_arr[metric]] = ts[metric]
        self.hot_value[rows_arr[~metric]] = values[~metric]
        self.hot_ts[rows_arr[~metric]] = ts[~metric]

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
        )
