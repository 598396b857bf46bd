"""W3C trace-context propagation for the placement pipeline.

Copy of ``crane_scheduler_tpu/telemetry/tracing.py``.

One placement crosses four processes — annotator sync stamps the
annotations, the scheduler ingests and scores them, the kube client
POSTs the binding, the watch stream confirms it. A trace ID minted at
pod first-seen (``lifecycle.PodLifecycleTracker.seen``) rides the
``traceparent`` header (https://www.w3.org/TR/trace-context/) across
the HTTP hops and a thread-local ``TraceContext`` within a process, so
every ``SpanRecorder`` span recorded under ``use(ctx)`` is stamped with
the trace and parented to the enclosing span.

Stdlib-only; ID generation is one random 128/64-bit base per process
plus a counter — no per-span ``os.urandom`` syscall on the hot path.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading

_TRACEPARENT_LEN = 55  # "00-" + 32 + "-" + 16 + "-" + 2 + separators
_HEX = set("0123456789abcdef")

# per-process random bases; the counter keeps successive IDs distinct
# without a syscall per span
_trace_base = int.from_bytes(os.urandom(16), "big") | 1
_span_base = int.from_bytes(os.urandom(8), "big") | 1
_counter = itertools.count(1)


def new_trace_id() -> str:
    """32 lowercase hex chars, never all-zero."""
    return f"{(_trace_base + (next(_counter) << 64)) & ((1 << 128) - 1) or 1:032x}"


def new_span_id() -> str:
    """16 lowercase hex chars, never all-zero."""
    return f"{(_span_base + next(_counter)) & ((1 << 64) - 1) or 1:016x}"


class TraceContext:
    """An active (trace_id, span_id) pair — the parent for new spans."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def child(self) -> "TraceContext":
        return TraceContext(self.trace_id, new_span_id())

    def __repr__(self):
        return f"TraceContext({self.trace_id!r}, {self.span_id!r})"

    def __eq__(self, other):
        return (
            isinstance(other, TraceContext)
            and self.trace_id == other.trace_id
            and self.span_id == other.span_id
        )


def new_context() -> TraceContext:
    return TraceContext(new_trace_id(), new_span_id())


def format_traceparent(ctx: TraceContext) -> str:
    """``00-<trace-id>-<parent-id>-01`` (sampled flag always set: the
    lifecycle tracker already decided this pod is tracked)."""
    return f"00-{ctx.trace_id}-{ctx.span_id}-01"


def _hexfield(s: str, width: int) -> bool:
    return len(s) == width and set(s) <= _HEX and set(s) != {"0"}


def parse_traceparent(value) -> TraceContext | None:
    """Strict W3C parse; returns None on anything malformed (a bad
    header must never break request handling). Future versions (> 00)
    are accepted as long as the first four fields are well-formed, per
    spec section 4.3."""
    if not value or not isinstance(value, str):
        return None
    parts = value.strip().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id, flags = parts[0], parts[1], parts[2], parts[3]
    if len(version) != 2 or set(version) - _HEX or version == "ff":
        return None
    if version == "00" and len(parts) != 4:
        return None
    if not _hexfield(trace_id, 32) or not _hexfield(span_id, 16):
        return None
    if len(flags) != 2 or set(flags) - _HEX:
        return None
    return TraceContext(trace_id, span_id)


_tls = threading.local()


def current() -> TraceContext | None:
    """The thread's active context (None when untraced — the disabled
    hot path is one ``getattr``)."""
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def use(ctx: TraceContext | None):
    """Install ``ctx`` as the thread's active context for the block;
    ``use(None)`` is a no-op passthrough (keeps call sites branch-free)."""
    if ctx is None:
        yield None
        return
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    try:
        yield ctx
    finally:
        _tls.ctx = prev
