"""Sampled per-decision traces with bounded memory.

Copy of ``crane_scheduler_tpu/telemetry/decisions.py``.

Answers "why did pod X land on node Y" after the fact (the question the
reference can only answer by replaying logs): each recorded decision
carries the filter verdict reasons, the top-k candidate scores, the
chosen node, and the staleness of the annotations the verdict consulted.
Gavel (arXiv:2008.09213) and Tesserae (arXiv:2508.04953) both lean on
exactly this per-decision visibility to validate policy behavior at
scale.

Memory is bounded two ways: a sampling stride (record every Nth
decision — the drip path is per pod, the batch path per burst) and a
fixed-capacity ring buffer (oldest evicted). Served by the scoring
sidecar's ``/debug/decisions`` endpoint.
"""

from __future__ import annotations

import threading
import time
from collections import deque


class DecisionTraceBuffer:
    def __init__(
        self,
        capacity: int = 512,
        sample_every: int = 1,
        clock=time.time,
    ):
        if capacity < 1 or sample_every < 1:
            raise ValueError("capacity and sample_every must be >= 1")
        self._buf: deque = deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self._clock = clock
        self.capacity = int(capacity)
        self.sample_every = int(sample_every)
        self.seen = 0  # decisions offered
        self.recorded = 0  # decisions kept (before ring eviction)

    def record(
        self,
        pod: str = "",
        node: str | None = None,
        reason: str = "",
        feasible: int = 0,
        top_scores=(),
        staleness_seconds: float = -1.0,
        source: str = "",
        **extra,
    ) -> bool:
        """Offer one decision; returns True when it was kept. The
        sampled-out fast path is one counter bump — callers may offer
        every decision unconditionally."""
        # GIL-serialized counter; a rare racy undercount only shifts
        # which decision the stride keeps, never unbounded memory
        self.seen += 1
        if (self.seen - 1) % self.sample_every:
            return False
        return self._append(
            pod, node, reason, feasible, top_scores, staleness_seconds,
            source, extra,
        )

    def offer(self, build) -> bool:
        """Like ``record`` but lazily: ``build()`` (returning ``record``'s
        kwargs) only runs when the sampling stride keeps the entry — the
        sampled-out fast path never pays for top-k extraction."""
        self.seen += 1
        if (self.seen - 1) % self.sample_every:
            return False
        kw = dict(build())
        extra = {
            k: kw.pop(k)
            for k in list(kw)
            if k not in (
                "pod", "node", "reason", "feasible", "top_scores",
                "staleness_seconds", "source",
            )
        }
        return self._append(
            kw.get("pod", ""),
            kw.get("node"),
            kw.get("reason", ""),
            kw.get("feasible", 0),
            kw.get("top_scores", ()),
            kw.get("staleness_seconds", -1.0),
            kw.get("source", ""),
            extra,
        )

    def _append(
        self, pod, node, reason, feasible, top_scores, staleness_seconds,
        source, extra,
    ) -> bool:
        entry = {
            "ts": self._clock(),
            "pod": pod,
            "node": node,
            "reason": reason,
            "feasible": int(feasible),
            "top_scores": [[str(n), int(s)] for n, s in top_scores],
            "staleness_seconds": round(float(staleness_seconds), 6),
            "source": source,
        }
        if extra:
            entry.update(extra)
        with self._lock:
            self.recorded += 1
            entry["seq"] = self.recorded  # flight-recorder drain cursor
            self._buf.append(entry)
        return True

    def drain_since(self, cursor: int) -> tuple[list[dict], int]:
        """Entries recorded after ``cursor`` (a seq from a prior call)
        plus the new cursor — the flight recorder's incremental pull."""
        with self._lock:
            new_cursor = self.recorded
            picked = [e for e in self._buf if e["seq"] > cursor]
        return picked, new_cursor

    def snapshot(self, limit: int | None = None) -> list[dict]:
        """Most recent decisions, oldest first; ``limit`` keeps the
        newest N."""
        with self._lock:
            entries = list(self._buf)
        if limit is not None and limit >= 0:
            entries = entries[-limit:]
        return entries

    def stats(self) -> dict:
        with self._lock:
            buffered = len(self._buf)
        return {
            "seen": self.seen,
            "recorded": self.recorded,
            "buffered": buffered,
            "capacity": self.capacity,
            "sample_every": self.sample_every,
        }
