"""Span recorder: pipeline stage timing -> Chrome trace-event JSON.

Copy of ``crane_scheduler_tpu/telemetry/spans.py``.

The Go scheduler's only latency visibility is log lines timing each
sync. ``torch_trace`` (utils/profiling.py) covers *device*-level
analysis; this recorder covers the *host* pipeline — the stages of the
pipelined scheduling loop (ingest, risk rescan, H2D, dispatch, async
D2H drain, bind flush, the overlap-refresh worker) land in a bounded
ring buffer and export as Chrome trace-event JSON, viewable in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing`` next to
``torch.profiler``'s own traces.

Tracks default to the recording thread's name, so the overlap-refresh
worker's spans land on their own track and visibly overlap the
scheduling thread's cycles — exactly the picture "why did cycle N's p99
spike" needs.

Trace propagation: when a ``tracing.TraceContext`` is active
(thread-local, or passed as ``ctx=``), spans are stamped with
``trace_id``/``span_id``/``parent_id`` and nested ``span()`` blocks
parent correctly. The export adds Perfetto flow events chaining spans
that share a trace ID — the visual thread stitching annotator sync →
ingest → dispatch → bind flush across tracks. Untraced spans pay one
thread-local ``getattr`` and carry no trace fields.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from collections import deque

from . import tracing

# ring entries: (ts_us, dur_us, name, track, args|None,
#                trace_id|None, span_id|None, parent_id|None, seq)
_UNTRACED = (None, None, None)


class SpanRecorder:
    """Bounded ring buffer of completed spans (oldest evicted first)."""

    def __init__(self, capacity: int = 16384, clock=time.perf_counter):
        self._clock = clock
        self._epoch = clock()
        self._buf: deque = deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self.recorded = 0  # total ever recorded (evictions included)
        self._seq = 0  # monotone id for flight-recorder drain cursors

    @contextlib.contextmanager
    def span(self, name: str, track: str | None = None, ctx=None, **args):
        """Record the wrapped block as one complete ('X') span. ``track``
        defaults to the current thread's name. When a trace context is
        active (``ctx=`` or thread-local), the span becomes its child and
        is itself the parent of spans recorded inside the block."""
        parent = ctx if ctx is not None else tracing.current()
        start = self._clock()
        if parent is None:
            try:
                yield
            finally:
                self.record(name, start, self._clock(), track=track, args=args)
            return
        child = parent.child()
        try:
            with tracing.use(child):
                yield
        finally:
            self.record(
                name, start, self._clock(), track=track, args=args,
                trace_id=parent.trace_id, span_id=child.span_id,
                parent_id=parent.span_id,
            )

    def record(
        self,
        name: str,
        start: float,
        end: float,
        track: str | None = None,
        args: dict | None = None,
        ctx=None,
        trace_id: str | None = None,
        span_id: str | None = None,
        parent_id: str | None = None,
    ) -> None:
        """Record a span from explicit ``clock()`` readings (for callers
        that only learn the span's metadata after it finished). Trace
        fields come from ``trace_id``/``span_id``/``parent_id`` when
        given, else from ``ctx`` or the thread-local context."""
        if track is None:
            track = threading.current_thread().name
        if trace_id is None:
            parent = ctx if ctx is not None else tracing.current()
            if parent is not None:
                trace_id = parent.trace_id
                span_id = tracing.new_span_id()
                parent_id = parent.span_id
        ts_us = (start - self._epoch) * 1e6
        dur_us = max(0.0, (end - start) * 1e6)
        with self._lock:
            self.recorded += 1
            self._seq += 1
            self._buf.append(
                (ts_us, dur_us, name, track, args or None,
                 trace_id, span_id, parent_id, self._seq)
            )

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    def export_chrome_trace(self) -> dict:
        """Chrome trace-event JSON object (``{"traceEvents": [...]}``):
        one ``ph: "X"`` complete event per span plus ``thread_name``
        metadata per track, events sorted by timestamp. Traced spans
        carry trace_id/span_id/parent_id in ``args`` and are linked by
        Perfetto flow events (``ph: s/t/f``) per trace ID."""
        with self._lock:
            # key=s[:2]: entries end in dicts — a (ts, dur, name, track)
            # tie must not fall through to comparing args
            spans = sorted(self._buf, key=lambda s: s[:2])
        tids: dict[str, int] = {}
        events: list[dict] = []
        flows: dict[str, list[tuple[float, int, str]]] = {}
        for ts_us, dur_us, name, track, args, trace_id, span_id, parent_id, _ in spans:
            tid = tids.get(track)
            if tid is None:
                tid = tids[track] = len(tids) + 1
            event = {
                "name": name,
                "ph": "X",
                "pid": 1,
                "tid": tid,
                "ts": round(ts_us, 3),
                "dur": round(dur_us, 3),
            }
            if trace_id is not None:
                targs = dict(args) if args else {}
                targs["trace_id"] = trace_id
                targs["span_id"] = span_id
                if parent_id is not None:
                    targs["parent_id"] = parent_id
                event["args"] = targs
                flows.setdefault(trace_id, []).append(
                    (round(ts_us, 3), tid, name)
                )
            elif args:
                event["args"] = args
            events.append(event)
        flow_events: list[dict] = []
        for trace_id, hops in flows.items():
            if len(hops) < 2:
                continue  # a flow needs at least two ends
            # 52-bit id fits a JS number; stable per trace
            fid = int(trace_id[:13], 16)
            for i, (ts, tid, name) in enumerate(hops):
                ph = "s" if i == 0 else ("f" if i == len(hops) - 1 else "t")
                ev = {
                    "name": "trace", "cat": "trace", "ph": ph, "id": fid,
                    "pid": 1, "tid": tid, "ts": ts,
                }
                if ph == "f":
                    ev["bp"] = "e"
                flow_events.append(ev)
        meta = [
            {
                "name": "thread_name",
                "ph": "M",
                "pid": 1,
                "tid": tid,
                "args": {"name": track},
            }
            for track, tid in tids.items()
        ]
        return {
            "traceEvents": meta + events + flow_events,
            "displayTimeUnit": "ms",
        }

    def drain_since(self, cursor: int) -> tuple[list[dict], int]:
        """Spans recorded after ``cursor`` (a seq from a prior call) as
        JSON-able dicts, plus the new cursor — the flight recorder's
        incremental pull. Ring evictions may drop spans between pulls;
        what remains is still ordered."""
        with self._lock:
            new_cursor = self._seq
            picked = [s for s in self._buf if s[8] > cursor]
        out = []
        for ts_us, dur_us, name, track, args, trace_id, span_id, parent_id, seq in picked:
            d = {
                "seq": seq,
                "ts_us": round(ts_us, 3),
                "dur_us": round(dur_us, 3),
                "name": name,
                "track": track,
            }
            if args:
                d["args"] = args
            if trace_id is not None:
                d["trace_id"] = trace_id
                d["span_id"] = span_id
                if parent_id is not None:
                    d["parent_id"] = parent_id
            out.append(d)
        return out, new_cursor

    def dump(self, path: str) -> int:
        """Write the Chrome trace to ``path`` atomically (temp file +
        ``os.replace`` — a crash mid-dump never leaves torn JSON);
        returns the span count."""
        trace = self.export_chrome_trace()
        d = os.path.dirname(os.path.abspath(path))
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".spans-", suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(trace, f)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return sum(1 for e in trace["traceEvents"] if e["ph"] == "X")
