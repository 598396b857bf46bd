"""Assumed-pod topology cache (the pre-bind window).

ref: pkg/plugins/noderesourcetopology/cache.go — a TTL map of
pod-key -> ZoneList covering the gap between Reserve and the result
annotation landing on the pod; cleaned periodically (reference: every 1s,
TTL 30m default). ``cleanup(now)`` takes time explicitly for deterministic
tests, as the reference does (cache.go:119-120).

Copy of ``crane_scheduler_tpu/topology/cache.py``.
"""

from __future__ import annotations

import threading
import time

from ..cluster.state import Pod
from .types import Zone

DEFAULT_TTL_SECONDS = 30 * 60.0
CLEAN_PERIOD_SECONDS = 1.0


class PodTopologyCache:
    def __init__(self, ttl_seconds: float = DEFAULT_TTL_SECONDS):
        self._ttl = ttl_seconds
        self._lock = threading.RLock()
        self._topology: dict[str, list[Zone]] = {}
        self._deadline: dict[str, float] = {}
        self._cleaner: threading.Thread | None = None
        self._stop = threading.Event()
        self._version = 0
        self._shrink_version = 0

    @property
    def version(self) -> int:
        """Monotonic mutation counter: the assumed set feeds NUMA usage
        reconstruction, so derived views (e.g. gang capacity vectors)
        cache against it."""
        with self._lock:
            return self._version

    @property
    def shrink_version(self) -> int:
        """Bumps only on REMOVALS (forget/expiry). Additions become
        visible to NUMA accounting only through a bound pod — which the
        cluster's pod-change journal records — so incremental
        wrapper-cache maintenance needs a full rebuild only when entries
        disappear without a corresponding bind journal entry."""
        with self._lock:
            return self._shrink_version

    def assume_pod(self, pod: Pod, zones: list[Zone], now: float | None = None) -> None:
        """ref: cache.go:53-69 — double-assume is an error."""
        key = pod.key()
        if now is None:
            now = time.time()
        with self._lock:
            if key in self._topology:
                raise KeyError(f"pod {key} is already assumed")
            self._topology[key] = list(zones)
            self._deadline[key] = now + self._ttl
            self._version += 1

    def assume_pods(self, items, now: float | None = None) -> None:
        """``assume_pod`` for many ``(pod, zones)`` pairs in one lock hold,
        the version moving once per pod as one at a time. A pod already
        assumed, or named twice, raises KeyError before any is assumed."""
        if now is None:
            now = time.time()
        items = list(items)
        with self._lock:
            keys = [pod.key() for pod, _zones in items]
            taken = [k for k in keys if k in self._topology]
            if taken or len(set(keys)) != len(keys):
                raise KeyError(f"pod {(taken or keys)[0]} is already assumed")
            deadline = now + self._ttl
            for key, (_pod, zones) in zip(keys, items):
                self._topology[key] = list(zones)
                self._deadline[key] = deadline
            self._version += len(keys)

    def assumed(self, keys) -> bool:
        """Whether any of ``keys`` is assumed."""
        with self._lock:
            return any(k in self._topology for k in keys)

    def forget_pods(self, pods) -> None:
        """``forget_pod`` for many pods in one lock hold."""
        with self._lock:
            for pod in pods:
                key = pod.key()
                if self._topology.pop(key, None) is not None:
                    self._version += 1
                    self._shrink_version += 1
                self._deadline.pop(key, None)

    def forget_pod(self, pod: Pod) -> None:
        """Idempotent removal (ref: cache.go:72-83)."""
        with self._lock:
            if self._topology.pop(pod.key(), None) is not None:
                self._version += 1
                self._shrink_version += 1
            self._deadline.pop(pod.key(), None)

    def pod_count(self) -> int:
        with self._lock:
            return len(self._topology)

    def get_pod_topology(self, pod: Pod) -> list[Zone]:
        """Raises KeyError when absent (ref: cache.go:94-109)."""
        with self._lock:
            return list(self._topology[pod.key()])

    def cleanup(self, now: float | None = None) -> None:
        """Drop expired entries (ref: cache.go:111-129)."""
        if now is None:
            now = time.time()
        with self._lock:
            expired = [k for k, dl in self._deadline.items() if now > dl]
            for k in expired:
                self._topology.pop(k, None)
                self._deadline.pop(k, None)
            if expired:
                self._version += 1
                self._shrink_version += 1

    def start_cleaner(self) -> None:
        if self._cleaner is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(timeout=CLEAN_PERIOD_SECONDS):
                self.cleanup()

        self._cleaner = threading.Thread(target=loop, daemon=True)
        self._cleaner.start()

    def stop_cleaner(self) -> None:
        self._stop.set()
        if self._cleaner is not None:
            self._cleaner.join(timeout=2.0)
            self._cleaner = None
