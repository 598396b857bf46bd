"""Tracing/profiling hooks.

Counterpart of ``crane_scheduler_tpu/utils/profiling.py``, with
``torch_trace`` in place of ``jax_trace``:

- ``PhaseTimer``: lightweight wall-clock phase timing with counters
  (always available, no deps);
- ``torch_trace``: wraps a block in ``torch.profiler`` (host and CUDA
  activity) and writes its trace under ``log_dir`` (viewable with
  TensorBoard's profiler plugin, Perfetto or ``chrome://tracing``) for
  device-level analysis of the kernels;
- ``chrome_trace``: dumps a telemetry ``SpanRecorder``'s host-side
  pipeline spans as Chrome trace-event JSON at block exit — the host
  twin of ``torch_trace`` (see ``crane_scheduler_tpu_torch.telemetry``).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class PhaseTimer:
    """Accumulates per-phase wall time and counts."""

    def __init__(self):
        self.seconds: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] += time.perf_counter() - start
            self.counts[name] += 1

    def report(self) -> dict:
        return {
            name: {
                "total_ms": round(self.seconds[name] * 1e3, 3),
                "count": self.counts[name],
                "mean_ms": round(self.seconds[name] * 1e3 / max(self.counts[name], 1), 3),
            }
            for name in sorted(self.seconds)
        }


@contextlib.contextmanager
def torch_trace(log_dir: str | None):
    """``torch.profiler`` trace of the block when ``log_dir`` is set, a
    no-op otherwise. Records host and (where a GPU is present) CUDA
    activity and writes one ``*.pt.trace.json`` file under ``log_dir``
    when the block exits; yields the profiler (``None`` when off), whose
    ``key_averages()`` the caller may read afterwards."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


@contextlib.contextmanager
def chrome_trace(recorder, path: str | None):
    """Write ``recorder``'s spans (telemetry.SpanRecorder) as a Chrome
    trace-event JSON file when the block exits; no-op when either side
    is unset. Pairs with ``torch_trace`` for host+device pictures of the
    same run."""
    try:
        yield
    finally:
        if recorder is not None and path:
            recorder.dump(path)
