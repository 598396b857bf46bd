"""Rate-limited work queue with per-item exponential backoff.

Copy of ``crane_scheduler_tpu/annotator/workqueue.py``.

Equivalent of client-go's ``workqueue.RateLimitingInterface`` as the
reference uses it (ref: pkg/controller/annotator/node.go:34-42):
deduplicating FIFO; ``add_rate_limited`` re-enqueues after an
exponential per-item delay (base 10s doubling to a 360s cap —
``ItemExponentialFailureRateLimiter(DefaultBackOff, MaxBackOff)``);
``forget`` resets an item's failure count.
"""

from __future__ import annotations

import heapq
import threading
import time
from collections import deque

from ..constants import DEFAULT_BACKOFF_SECONDS, MAX_BACKOFF_SECONDS


class RateLimitedQueue:
    def __init__(
        self,
        base_delay: float = DEFAULT_BACKOFF_SECONDS,
        max_delay: float = MAX_BACKOFF_SECONDS,
        clock=time.monotonic,
    ):
        self._base = base_delay
        self._max = max_delay
        self._clock = clock
        self._cond = threading.Condition()
        self._queue: deque[str] = deque()
        self._pending: set[str] = set()  # queued or delayed, not yet handed out
        self._processing: set[str] = set()
        self._dirty: set[str] = set()  # re-added while processing
        self._failures: dict[str, int] = {}
        self._delayed: list[tuple[float, str]] = []
        self._shutdown = False

    def add(self, item: str) -> None:
        with self._cond:
            if self._shutdown:
                return
            if item in self._pending:
                return
            if item in self._processing:
                # client-go marks it dirty; it re-queues on done().
                self._dirty.add(item)
                return
            self._pending.add(item)
            self._queue.append(item)
            self._cond.notify()

    def add_rate_limited(self, item: str) -> None:
        with self._cond:
            if self._shutdown:
                return
            failures = self._failures.get(item, 0)
            delay = min(self._base * (2**failures), self._max)
            self._failures[item] = failures + 1
            self._schedule_locked(item, self._clock() + delay)

    def add_after(self, item: str, delay: float) -> None:
        with self._cond:
            if self._shutdown:
                return
            self._schedule_locked(item, self._clock() + delay)

    def _schedule_locked(self, item: str, ready_at: float) -> None:
        heapq.heappush(self._delayed, (ready_at, item))
        self._cond.notify()

    def forget(self, item: str) -> None:
        with self._cond:
            self._failures.pop(item, None)

    def get(self, timeout: float | None = None):
        """Blocking pop; returns None on shutdown or timeout."""
        deadline = None if timeout is None else self._clock() + timeout
        with self._cond:
            while True:
                self._drain_delayed_locked()
                if self._queue:
                    item = self._queue.popleft()
                    self._pending.discard(item)
                    self._processing.add(item)
                    return item
                if self._shutdown:
                    return None
                wait = None
                if self._delayed:
                    wait = max(0.0, self._delayed[0][0] - self._clock())
                if deadline is not None:
                    remaining = deadline - self._clock()
                    if remaining <= 0:
                        return None
                    wait = remaining if wait is None else min(wait, remaining)
                self._cond.wait(timeout=wait if wait is not None else 1.0)

    def done(self, item: str) -> None:
        with self._cond:
            self._processing.discard(item)
            if item in self._dirty:
                self._dirty.discard(item)
                if item not in self._pending:
                    self._pending.add(item)
                    self._queue.append(item)
                    self._cond.notify()

    def _drain_delayed_locked(self) -> None:
        now = self._clock()
        while self._delayed and self._delayed[0][0] <= now:
            _, item = heapq.heappop(self._delayed)
            if item in self._pending:
                continue
            if item in self._processing:
                self._dirty.add(item)
                continue
            self._pending.add(item)
            self._queue.append(item)

    def shutdown(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()

    def __len__(self) -> int:
        with self._cond:
            return len(self._queue) + len(self._delayed)
