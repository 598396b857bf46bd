"""Bounded binding-records heap feeding the hot-value counters.

Reproduces ``BindingRecords`` (ref: pkg/controller/annotator/binding.go):
a size-capped min-heap ordered by timestamp; inserting into a full heap
evicts the oldest record; ``get_last_node_binding_count`` is a linear scan
counting bindings on a node strictly newer than ``now - time_range``; GC
pops expired records (older than the max hot-value window).

Copy of ``crane_scheduler_tpu/annotator/bindings.py``. The annotator takes
the C++ heap (``native/bindings.py``) by default, as the reference does;
this pure-Python heap is its twin (``AnnotatorConfig(use_native_bindings=
False)``). Both give the same counts.
"""

from __future__ import annotations

import heapq
import threading
import time
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Binding:
    node: str
    namespace: str
    pod_name: str
    timestamp: int  # unix seconds (ref: binding.go:18)


class BindingRecords:
    """ref: binding.go:50-123."""

    def __init__(self, size: int, gc_time_range_seconds: float):
        self._size = int(size)
        self._gc_time_range = gc_time_range_seconds
        self._heap: list[tuple[int, int, Binding]] = []
        self._seq = 0
        self._version = 0  # moves on every push and pop
        self._lock = threading.RLock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)

    @property
    def version(self) -> int:
        """Moves on every change of the heap (a push or a GC pop): the
        key of the annotator's per-sweep hot-value memo."""
        with self._lock:
            return self._version

    def add_binding(self, binding: Binding) -> None:
        """Push; evict the oldest first when full (ref: binding.go:69-78)."""
        self.add_binding_batch((binding,))

    def add_binding_batch(self, bindings) -> None:
        """Push a burst under one lock hold; the evict+push invariant
        lives only here (``add_binding`` delegates)."""
        with self._lock:
            self._version += 1
            for binding in bindings:
                if len(self._heap) == self._size:
                    heapq.heappop(self._heap)
                self._seq += 1
                heapq.heappush(
                    self._heap, (binding.timestamp, self._seq, binding)
                )

    def add_bind_columns(self, node_table, node_idx, ts: int) -> None:
        """Columnar push: one (node_table[i], ts) record per ``node_idx``
        entry — identical heap state to ``add_binding_batch`` over
        equivalent Bindings (namespace/pod are not part of the count
        semantics, ref: binding.go:81-97)."""
        ts = int(ts)
        bindings = [
            Binding(
                node=node_table[int(i)], namespace="", pod_name="", timestamp=ts
            )
            for i in node_idx
        ]
        self.add_binding_batch(bindings)

    def get_last_node_binding_count(
        self, node: str, time_range_seconds: float, now: float | None = None
    ) -> int:
        """Count bindings on ``node`` strictly newer than the window start
        (ref: binding.go:81-97 — ``binding.Timestamp > timeline``)."""
        if now is None:
            now = time.time()
        timeline = int(now) - int(time_range_seconds)
        with self._lock:
            return sum(
                1
                for _, _, b in self._heap
                if b.timestamp > timeline and b.node == node
            )

    def counts_batch(
        self, windows_seconds, now: float | None = None
    ) -> tuple[list[str], np.ndarray]:
        """(node_names, counts[window, node]) for every node present in the
        heap, in ONE pass — vs the reference's per-(node, window) rescans
        (ref: binding.go:81-97). Same strict ``timestamp > timeline``
        window semantics as ``get_last_node_binding_count``."""
        if now is None:
            now = time.time()
        # plain-int timelines: the inner loop runs |heap|·|windows| times,
        # and boxed numpy scalar comparisons would dominate it
        timelines = [int(now) - int(w) for w in windows_seconds]
        nw = len(timelines)
        with self._lock:
            ids: dict[str, int] = {}
            names: list[str] = []
            per_window: list[list[int]] = [[] for _ in range(nw)]
            for _, _, b in self._heap:
                node_id = ids.get(b.node)
                if node_id is None:
                    node_id = len(names)
                    ids[b.node] = node_id
                    names.append(b.node)
                    for col in per_window:
                        col.append(0)
                ts = b.timestamp
                for i in range(nw):
                    if ts > timelines[i]:
                        per_window[i][node_id] += 1
            return names, np.asarray(per_window, dtype=np.int64).reshape(
                nw, len(names)
            )

    def bindings_gc(self, now: float | None = None) -> None:
        """Pop expired records; stop at the first live one
        (ref: binding.go:100-123)."""
        if now is None:
            now = time.time()
        with self._lock:
            if self._gc_time_range == 0:
                return
            timeline = int(now) - int(self._gc_time_range)
            while self._heap:
                ts, seq, binding = heapq.heappop(self._heap)
                if binding.timestamp > timeline:
                    heapq.heappush(self._heap, (ts, seq, binding))
                    return
                self._version += 1


def max_hot_value_time_range(hot_value_policies) -> float:
    """GC window = the largest hot-value timeRange
    (ref: pkg/controller/annotator/utils.go:25-39)."""
    max_range = 0.0
    for p in hot_value_policies or ():
        if p.time_range_seconds > max_range:
            max_range = p.time_range_seconds
    return max_range
