"""The C++ binding heap (drop-in for ``annotator.BindingRecords``).

Copy of ``crane_scheduler_tpu/native/bindings.py``. Same semantics as the
Python heap (ref: binding.go), plus a batch API: ``counts_batch`` computes
every node's windowed binding count for all hot-value windows in one pass
over the heap, where the Go original rescans the heap per (node, window).
The port adds ``version`` (it moves on every push and GC call), the key of
the annotator's per-sweep hot-value memo, as the Python heap has it.
"""

from __future__ import annotations

import ctypes
import threading
import time

import numpy as np

from ..annotator.bindings import Binding
from .lib import load_native

_P_I32 = ctypes.POINTER(ctypes.c_int32)
_P_I64 = ctypes.POINTER(ctypes.c_int64)


class NativeBindingRecords:
    def __init__(self, size: int, gc_time_range_seconds: float):
        lib = load_native()
        self._lib = lib
        self._handle = lib.crane_bindings_new(int(size), int(gc_time_range_seconds))
        self._lock = threading.RLock()
        self._node_ids: dict[str, int] = {}
        self._names: list[str] = []
        self._version = 0
        self._table_ids_cache = None

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.crane_bindings_free(handle)
            self._handle = None

    def __len__(self) -> int:
        with self._lock:
            return int(self._lib.crane_bindings_len(self._handle))

    @property
    def version(self) -> int:
        """Moves on every push and every GC call (a GC that pops nothing
        moves it too: the memo it keys is only recomputed)."""
        with self._lock:
            return self._version

    def _intern(self, node: str) -> int:
        node_id = self._node_ids.get(node)
        if node_id is None:
            node_id = len(self._names)
            self._node_ids[node] = node_id
            self._names.append(node)
        return node_id

    def add_binding(self, binding: Binding) -> None:
        with self._lock:
            self._version += 1
            self._lib.crane_bindings_add(
                self._handle, self._intern(binding.node), int(binding.timestamp)
            )

    def _push(self, ids: np.ndarray, ts: np.ndarray) -> None:
        self._version += 1
        self._lib.crane_bindings_add_batch(
            self._handle, ids.ctypes.data_as(_P_I32), ts.ctypes.data_as(_P_I64), len(ids),
        )

    def add_binding_batch(self, bindings) -> None:
        """Push a burst in one FFI crossing (identical semantics and
        order to per-binding ``add_binding``)."""
        bindings = list(bindings)
        if not bindings:
            return
        with self._lock:
            ids = np.fromiter((self._intern(b.node) for b in bindings),
                              dtype=np.int32, count=len(bindings))
            ts = np.fromiter((int(b.timestamp) for b in bindings),
                             dtype=np.int64, count=len(bindings))
            self._push(ids, ts)

    def add_bind_columns(self, node_table, node_idx, ts: int) -> None:
        """Columnar push: intern the node table once, map the per-pod
        index column through it with numpy, and push the whole burst in
        one FFI call. The interned ids are cached on the table object
        when it is a tuple (the burst path reuses one immutable tuple per
        snapshot); a list always re-interns, since it could change in
        place with its identity unchanged."""
        node_idx = np.asarray(node_idx, dtype=np.int64)
        n = len(node_idx)
        if not n:
            return
        with self._lock:
            cache = self._table_ids_cache
            if cache is not None and cache[0] is node_table and isinstance(node_table, tuple):
                table_ids = cache[1]
            else:
                table_ids = np.fromiter((self._intern(name) for name in node_table),
                                        dtype=np.int32, count=len(node_table))
                self._table_ids_cache = (node_table, table_ids)
            self._push(np.ascontiguousarray(table_ids[node_idx]),
                       np.full((n,), int(ts), dtype=np.int64))

    def get_last_node_binding_count(
        self, node: str, time_range_seconds: float, now: float | None = None
    ) -> int:
        if now is None:
            now = time.time()
        with self._lock:
            node_id = self._node_ids.get(node)
            if node_id is None:
                return 0
            return int(self._lib.crane_bindings_count(
                self._handle, node_id, int(time_range_seconds), int(now)))

    def counts_batch(
        self, windows_seconds, now: float | None = None
    ) -> tuple[list[str], np.ndarray]:
        """(node_names, counts[window, node]) for all interned nodes."""
        if now is None:
            now = time.time()
        with self._lock:
            n = len(self._names)
            w = np.asarray(windows_seconds, dtype=np.int64)
            out = np.zeros((len(w), max(n, 1)), dtype=np.int64)
            if n:
                self._lib.crane_bindings_counts_batch(
                    self._handle, n, w.ctypes.data_as(_P_I64), len(w), int(now),
                    out.ctypes.data_as(_P_I64),
                )
            return list(self._names), out[:, :n]

    def bindings_gc(self, now: float | None = None) -> None:
        if now is None:
            now = time.time()
        with self._lock:
            self._version += 1
            self._lib.crane_bindings_gc(self._handle, int(now))
