"""Pod-lifecycle tracking: first-seen -> bind-confirmed, end to end.

Copy of ``crane_scheduler_tpu/telemetry/lifecycle.py``.

The decoupled annotator -> scheduler -> service -> descheduler pipeline
had no answer to "how long from pod-seen to bind-confirmed"
— each process only timed its own stages. This module owns the bounded
per-pod state machine that stitches them:

- ``PodLifecycleTracker`` — per-pod records walking ``seen ->
  filtered -> scored -> bind_post -> watch_confirm`` (plus ``evicted``
  for the descheduler loop; a re-placed pod keeps its trace ID and
  bumps ``attempt``). Stage timestamps come off the existing hooks
  (mirror ingest, dispatch, bind flush, watch apply), both wall-clock
  and monotonic. Completion observes
  ``crane_placement_stage_seconds{stage}`` and the
  ``crane_placement_e2e_seconds`` headline (with a trace-ID exemplar),
  emits per-stage spans into the process ``SpanRecorder`` under the
  pod's trace, and pushes the finished record to a bounded ring —
  joinable to decision traces by pod key and timestamp.
- ``FlightRecorder`` — a crash-safe on-disk JSONL ring (size-capped
  segments, oldest deleted) of lifecycle records + spans + decisions;
  ``FlightRecorder.read`` replays it.
- ``slo_report`` — p50/p99 per stage and e2e compliance / burn rate
  against a target, computed from raw records so the CLI and bench can
  cross-check the histogram.

Memory is bounded three ways: a live-record cap (oldest dropped), a
completed ring, and ``batch_sample`` — the batch/burst paths track only
a prefix sample of each dispatch (100k-pod cycles must not pay
O(pods)).

Watch events may outrun POST acks (the stub — and a busy apiserver —
can deliver the confirming watch before the writer thread marks the
POST done): stages store absolute timestamps, so ``watch_confirm``
arriving before ``bind_post`` is recorded as-is and the record
finalizes once both are present, with negative stage deltas clamped
to zero.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict, deque

from . import tracing

STAGES = ("seen", "filtered", "scored", "bind_post", "watch_confirm")

_JSON_SEP = (",", ":")


class PodLifecycleTracker:
    """Bounded per-pod placement state machine. All methods are
    thread-safe and cheap on untracked keys (one dict miss)."""

    def __init__(
        self,
        registry=None,
        spans=None,
        capacity: int = 8192,
        completed_capacity: int = 2048,
        batch_sample: int = 16,
        clock=time.time,
        mono=time.perf_counter,
        flight=None,
    ):
        self._registry = registry
        self._spans = spans
        self._clock = clock
        self._mono = mono
        self.capacity = int(capacity)
        self.batch_sample = int(batch_sample)
        self.flight = flight
        self._lock = threading.Lock()
        self._live: OrderedDict[str, dict] = OrderedDict()
        self._completed: deque = deque(maxlen=int(completed_capacity))
        # evicted pods keep their trace across re-placement attempts
        self._evicted_traces: OrderedDict[str, tuple[str, int]] = OrderedDict()
        # (trace, attempt) of each finalized record — an eviction landing
        # AFTER the placement finalized still continues the pod's trace
        self._last_traces: OrderedDict[str, tuple[str, int]] = OrderedDict()
        self._m_stage = None
        self._m_e2e = None
        self._stage_children: dict = {}  # labeled-child cache (finalize)
        self.tracked_total = 0
        self.confirmed_total = 0
        self.evicted_total = 0
        self.dropped_total = 0

    # -- metrics (lazy: don't pollute exposition until a pod completes) --

    def ensure_metrics(self) -> None:
        if self._m_e2e is not None or self._registry is None:
            return
        self._m_stage = self._registry.histogram(
            "crane_placement_stage_seconds",
            "Per-stage placement latency (delta to the previous stage)",
            labelnames=("stage",),
        )
        self._m_e2e = self._registry.histogram(
            "crane_placement_e2e_seconds",
            "Pod first-seen to watch-confirmed placement latency",
        )
        # finalize runs per confirmed pod; skip the labels() lookup there
        self._stage_children = {
            s: self._m_stage.labels(stage=s) for s in STAGES[1:]
        }

    # -- state machine ---------------------------------------------------

    def _new_record(self, key: str, source: str, now: float, m: float) -> dict:
        trace_id = tracing.new_trace_id()
        attempt = 1
        prior = self._evicted_traces.pop(key, None)
        if prior is not None:
            trace_id, attempt = prior[0], prior[1] + 1
        rec = {
            "pod": key,
            "trace_id": trace_id,
            "root_span": tracing.new_span_id(),
            "attempt": attempt,
            "source": source,
            "node": None,
            "anno_ts": None,
            "cycle_trace": None,
            "stages": {"seen": now},
            "mono": {"seen": m},
            "evicted": False,
            "done": False,
        }
        if len(self._live) >= self.capacity:
            _, dropped = self._live.popitem(last=False)
            self.dropped_total += 1
            self._completed.append(dropped)
        self._live[key] = rec
        self.tracked_total += 1
        return rec

    def seen(self, key: str, source: str = "drip"):
        """Start (or resume) tracking; returns the pod's root
        ``TraceContext``. Idempotent on a live record."""
        now, m = self._clock(), self._mono()
        with self._lock:
            rec = self._live.get(key)
            if rec is None:
                rec = self._new_record(key, source, now, m)
            return tracing.TraceContext(rec["trace_id"], rec["root_span"])

    def seen_batch(self, keys, source: str = "batch") -> list[str]:
        """Track a prefix sample of a dispatch batch; returns the tracked
        subset — later stages iterate only this, keeping the batch path
        O(batch_sample), not O(pods)."""
        sample = keys[: self.batch_sample]
        if not sample:
            return []
        now, m = self._clock(), self._mono()
        tracked = []
        with self._lock:
            for key in sample:
                if key not in self._live:
                    self._new_record(key, source, now, m)
                tracked.append(key)
        return tracked

    def _stage_locked(self, rec, stage, now, m, node=None):
        stages = rec["stages"]
        if node is not None:
            rec["node"] = node
        if stage in stages:
            return  # idempotent: repeated watch applies re-confirm
        prev_m = rec["mono"].get(self._prev_present(rec, stage))
        stages[stage] = now
        rec["mono"][stage] = m
        if self._spans is not None:
            self._spans.record(
                f"lifecycle:{stage}",
                prev_m if prev_m is not None else m,
                m,
                track="lifecycle",
                args={"pod": rec["pod"], "attempt": rec["attempt"]},
                trace_id=rec["trace_id"],
                span_id=tracing.new_span_id(),
                parent_id=rec["root_span"],
            )

    @staticmethod
    def _prev_present(rec, stage):
        try:
            i = STAGES.index(stage)
        except ValueError:
            return "seen"
        for s in reversed(STAGES[:i]):
            if s in rec["mono"]:
                return s
        return "seen"

    def stage(self, key: str, stage: str, node: str | None = None,
              cycle_trace: str | None = None,
              anno_ts: float | None = None) -> bool:
        """Mark ``stage`` reached for a tracked pod (no-op on untracked
        keys). Finalizes the record once both ``bind_post`` and
        ``watch_confirm`` are present, in either order."""
        with self._lock:
            rec = self._live.get(key)
            if rec is None:
                return False
            now, m = self._clock(), self._mono()
            self._stage_locked(rec, stage, now, m, node=node)
            if cycle_trace is not None:
                rec["cycle_trace"] = cycle_trace
            if anno_ts is not None:
                rec["anno_ts"] = anno_ts
            if "bind_post" in rec["stages"] and "watch_confirm" in rec["stages"]:
                self._finalize_locked(key, rec)
            return True

    def stage_batch(self, keys, stage: str, cycle_trace=None, anno_ts=None):
        """One clock read for a whole tracked subset (the drain-side
        hook of the pipelined loops)."""
        if not keys:
            return
        now, m = self._clock(), self._mono()
        with self._lock:
            for key in keys:
                rec = self._live.get(key)
                if rec is None:
                    continue
                self._stage_locked(rec, stage, now, m)
                if cycle_trace is not None:
                    rec["cycle_trace"] = cycle_trace
                if anno_ts is not None:
                    rec["anno_ts"] = anno_ts

    def posted_batch(self, pairs):
        """Mark ``bind_post`` for ``(key, node)`` pairs — the bind-flush
        hook (background thread on the pipelined path)."""
        pairs = list(pairs)
        if not pairs:
            return
        now, m = self._clock(), self._mono()
        with self._lock:
            for key, node in pairs:
                rec = self._live.get(key)
                if rec is None:
                    continue
                self._stage_locked(rec, "bind_post", now, m, node=node)
                if "watch_confirm" in rec["stages"]:
                    self._finalize_locked(key, rec)

    def posted(self, key: str, node: str | None = None) -> bool:
        return self.stage(key, "bind_post", node=node)

    def confirmed_batch(self, pairs):
        """Mark ``watch_confirm`` for ``(key, node)`` pairs — the
        coalesced watch-apply hook (one lock + one clock read per event
        batch; untracked keys cost one dict miss each)."""
        pairs = list(pairs)
        if not pairs:
            return
        now, m = self._clock(), self._mono()
        with self._lock:
            for key, node in pairs:
                rec = self._live.get(key)
                if rec is None:
                    continue
                self._stage_locked(rec, "watch_confirm", now, m, node=node)
                if "bind_post" in rec["stages"]:
                    self._finalize_locked(key, rec)

    def confirmed(self, key: str, node: str | None = None) -> bool:
        """The watch stream confirmed the pod landed on ``node`` — the
        e2e endpoint. Tolerates arriving before the POST ack."""
        return self.stage(key, "watch_confirm", node=node)

    def rearm(self, key: str, trace_id: str, attempt: int = 1) -> None:
        """Restart reconciliation hook: a pod whose bind intent was lost
        in a crash re-enters scheduling on the SAME trace id at
        ``attempt + 1`` — its next ``seen()`` continues the story the
        dead process started."""
        with self._lock:
            self._evicted_traces[key] = (trace_id, int(attempt))
            while len(self._evicted_traces) > self.capacity:
                self._evicted_traces.popitem(last=False)

    def evicted(self, key: str, reason: str = "") -> None:
        """Descheduler hook: finalize the current attempt as evicted and
        remember the trace so a re-placement continues it."""
        now, m = self._clock(), self._mono()
        with self._lock:
            rec = self._live.get(key)
            if rec is None:
                # an eviction-only process (standalone descheduler) still
                # gets a record for its flight recorder; if this process
                # placed the pod earlier the finalized record's trace
                # continues
                rec = self._new_record(key, "evict", now, m)
                prior = self._last_traces.get(key)
                if prior is not None:
                    rec["trace_id"], rec["attempt"] = prior
            self._stage_locked(rec, "evicted", now, m)
            rec["evicted"] = True
            if reason:
                rec["evict_reason"] = reason
            self.evicted_total += 1
            self._evicted_traces[key] = (rec["trace_id"], rec["attempt"])
            while len(self._evicted_traces) > self.capacity:
                self._evicted_traces.popitem(last=False)
            self._finalize_locked(key, rec)

    def _finalize_locked(self, key: str, rec: dict) -> None:
        self._live.pop(key, None)
        rec["done"] = True
        mono = rec["mono"]
        if not rec["evicted"]:
            self.confirmed_total += 1
            self.ensure_metrics()
            if self._m_e2e is not None:
                prev = mono["seen"]
                children = self._stage_children
                for s in STAGES[1:]:
                    t = mono.get(s)
                    if t is None:
                        continue
                    children[s].observe(max(0.0, t - prev))
                    prev = t
                e2e = max(0.0, mono.get("watch_confirm", prev) - mono["seen"])
                self._m_e2e.observe(
                    e2e, exemplar={"trace_id": rec["trace_id"]}
                )
        self._completed.append(rec)
        self._last_traces[key] = (rec["trace_id"], rec["attempt"])
        while len(self._last_traces) > self.capacity:
            self._last_traces.popitem(last=False)
        if self.flight is not None:
            self.flight.write("lifecycle", rec)

    # -- read side -------------------------------------------------------

    def traceparent(self, key: str) -> str | None:
        """The W3C header value for a live pod's root context (stamped on
        its bind/evict POSTs by the kube client)."""
        with self._lock:
            rec = self._live.get(key)
            if rec is None:
                return None
            return tracing.format_traceparent(
                tracing.TraceContext(rec["trace_id"], rec["root_span"])
            )

    def traceparent_batch(self, keys) -> dict:
        """``{key: traceparent}`` for the tracked subset of ``keys`` —
        one lock acquisition for a whole POST batch."""
        out = {}
        with self._lock:
            live = self._live
            for key in keys:
                rec = live.get(key)
                if rec is not None:
                    out[key] = (
                        f"00-{rec['trace_id']}-{rec['root_span']}-01"
                    )
        return out

    def records(self, limit: int | None = None) -> list[dict]:
        """Completed records, oldest first."""
        with self._lock:
            out = list(self._completed)
        if limit is not None and limit >= 0:
            out = out[-limit:]
        return out

    def live_count(self) -> int:
        with self._lock:
            return len(self._live)

    def stats(self) -> dict:
        with self._lock:
            live, completed = len(self._live), len(self._completed)
        return {
            "live": live,
            "completed": completed,
            "tracked_total": self.tracked_total,
            "confirmed_total": self.confirmed_total,
            "evicted_total": self.evicted_total,
            "dropped_total": self.dropped_total,
            "capacity": self.capacity,
            "batch_sample": self.batch_sample,
        }

    def snapshot(self, limit: int | None = None) -> dict:
        """JSON-able view for ``/debug/lifecycle``."""
        return {"stats": self.stats(), "records": self.records(limit=limit)}


class FlightRecorder:
    """Crash-safe bounded JSONL ring on disk.

    Records append to ``flight-<n>.jsonl`` segments; a segment passing
    ``max_segment_bytes`` rotates to the next index and the oldest
    segment beyond ``max_segments`` is deleted. Every record is one
    ``write()`` of a full line followed by a flush, and the reader skips
    unparseable lines — a crash can lose at most the torn tail, never
    corrupt the ring. ``fsync=True`` additionally fsyncs each line so
    the tail survives power loss, not just process death — the intent
    journal's durability mode (``--flight-fsync``)."""

    def __init__(self, directory: str, max_segment_bytes: int = 4 << 20,
                 max_segments: int = 8, fsync: bool = False):
        self.directory = directory
        self.max_segment_bytes = int(max_segment_bytes)
        self.max_segments = int(max_segments)
        self.fsync = bool(fsync)
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        indices = self._segment_indices()
        self._index = indices[-1] if indices else 1
        self._file = open(self._segment_path(self._index), "a")
        self._size = self._file.tell()

    def _segment_path(self, index: int) -> str:
        return os.path.join(self.directory, f"flight-{index:06d}.jsonl")

    def _segment_indices(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("flight-") and name.endswith(".jsonl"):
                try:
                    out.append(int(name[len("flight-"):-len(".jsonl")]))
                except ValueError:
                    continue
        return sorted(out)

    def write(self, kind: str, obj: dict) -> None:
        line = json.dumps(
            {"kind": kind, **obj}, separators=_JSON_SEP, default=str
        )
        with self._lock:
            self._file.write(line + "\n")
            self._file.flush()
            if self.fsync:
                os.fsync(self._file.fileno())
            self._size += len(line) + 1
            if self._size >= self.max_segment_bytes:
                self._rotate_locked()

    def write_many(self, kind: str, objs) -> int:
        n = 0
        for obj in objs:
            self.write(kind, obj)
            n += 1
        return n

    def _rotate_locked(self) -> None:
        self._file.close()
        self._index += 1
        self._file = open(self._segment_path(self._index), "a")
        self._size = 0
        indices = self._segment_indices()
        while len(indices) > self.max_segments:
            oldest = indices.pop(0)
            try:
                os.unlink(self._segment_path(oldest))
            except OSError:
                pass

    def close(self) -> None:
        with self._lock:
            try:
                self._file.close()
            except OSError:
                pass

    @staticmethod
    def read(directory: str):
        """Yield records from all segments, oldest first, skipping torn
        or foreign lines."""
        if not os.path.isdir(directory):
            return
        names = sorted(
            n for n in os.listdir(directory)
            if n.startswith("flight-") and n.endswith(".jsonl")
        )
        for name in names:
            try:
                with open(os.path.join(directory, name)) as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            obj = json.loads(line)
                        except ValueError:
                            continue  # torn tail from a crash
                        if isinstance(obj, dict):
                            yield obj
            except OSError:
                continue


# -- SLO math ------------------------------------------------------------


def percentile(values, q: float) -> float:
    """Nearest-rank percentile on a sequence (0 < q <= 1)."""
    vals = sorted(values)
    if not vals:
        return float("nan")
    idx = max(0, min(len(vals) - 1, int(round(q * len(vals) + 0.5)) - 1))
    return vals[idx]


def stage_durations(rec: dict) -> dict:
    """Per-stage deltas (seconds, monotonic, clamped >= 0) for one
    record — later stages may have landed out of order."""
    mono = rec.get("mono") or {}
    out = {}
    prev = mono.get("seen")
    if prev is None:
        return out
    for s in STAGES[1:]:
        t = mono.get(s)
        if t is None:
            continue
        out[s] = max(0.0, t - prev)
        prev = t
    if "watch_confirm" in mono:
        out["e2e"] = max(0.0, mono["watch_confirm"] - mono["seen"])
    return out


def slo_report(records, target_seconds: float | None = None,
               objective: float = 0.99) -> dict:
    """p50/p99 per stage + e2e compliance/burn-rate from raw lifecycle
    records. ``burn_rate`` is (observed error rate) / (error budget):
    1.0 means exactly consuming the budget, > 1 means burning it."""
    stages: dict[str, list[float]] = {}
    e2e: list[float] = []
    confirmed = evicted = 0
    for rec in records:
        if rec.get("evicted"):
            evicted += 1
            continue
        durs = stage_durations(rec)
        if "e2e" in durs:
            confirmed += 1
            e2e.append(durs.pop("e2e"))
        for s, d in durs.items():
            stages.setdefault(s, []).append(d)
    report = {
        "confirmed": confirmed,
        "evicted": evicted,
        "stages": {
            s: {
                "count": len(v),
                "p50": percentile(v, 0.50),
                "p99": percentile(v, 0.99),
            }
            for s, v in sorted(stages.items())
        },
        "e2e": {
            "count": len(e2e),
            "p50": percentile(e2e, 0.50) if e2e else None,
            "p99": percentile(e2e, 0.99) if e2e else None,
            "sum": sum(e2e),
        },
    }
    if target_seconds is not None and e2e:
        good = sum(1 for v in e2e if v <= target_seconds)
        compliance = good / len(e2e)
        budget = 1.0 - objective
        report["slo"] = {
            "target_seconds": target_seconds,
            "objective": objective,
            "compliance": compliance,
            "burn_rate": (
                (1.0 - compliance) / budget if budget > 0 else float("inf")
            ),
        }
    return report
