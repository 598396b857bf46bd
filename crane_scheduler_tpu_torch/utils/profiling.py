"""Tracing/profiling hooks.

Counterpart of ``crane_scheduler_tpu/utils/profiling.py``, with
``torch_trace`` in place of ``jax_trace``:

- ``torch_trace``: wraps a block in ``torch.profiler`` (host and CUDA
  activity) and writes its trace under ``log_dir`` (viewable with
  TensorBoard's profiler plugin, Perfetto or ``chrome://tracing``) for
  device-level analysis of the kernels; the port's spans and drip-window
  stages land in it as host ranges, on the profiler's clock;
- ``device_idle_by_range``: where the device waited in such a trace, by
  the innermost host range open while it had nothing to run;
- ``chrome_trace``: dumps a telemetry ``SpanRecorder``'s host-side
  pipeline spans as Chrome trace-event JSON at block exit — the host
  twin of ``torch_trace`` (see ``crane_scheduler_tpu_torch.telemetry``).
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def torch_trace(log_dir: str | None):
    """``torch.profiler`` trace of the block when ``log_dir`` is set, a
    no-op otherwise. Records host and (where a GPU is present) CUDA
    activity, with the port's spans and stages as ranges
    (``telemetry.profiler_ranges``), and writes one ``*.pt.trace.json``
    file under ``log_dir`` when the block exits; yields the profiler
    (``None`` when off), whose ``key_averages()`` and ``events()`` the
    caller may read afterwards."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    from ..telemetry import profiler_ranges

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        with profiler_ranges():
            yield prof


def device_idle_by_range(events) -> dict:
    """Idle seconds of the device between its first and last operation in
    a profiler session's ``events()``, by the innermost host range
    (``record_function``) open during each idle stretch; a stretch that
    crosses ranges is split by overlap, and what no range covers is booked
    to ``None``. Device-side copies of host ranges (the profiler's GPU
    annotations, named as the ranges) are not device work."""
    from torch.autograd import DeviceType

    # by start, and the outer of two that start together first
    ranges = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                     if e.device_type == DeviceType.CPU
                     and getattr(e, "is_user_annotation", False)),
                    key=lambda r: (r[0], -r[1]))
    names = {name for _s, _e, name in ranges}
    dev = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.device_type != DeviceType.CPU and e.name not in names
                 and e.time_range.end > e.time_range.start)
    gaps = []
    if dev:
        end = dev[0][1]
        for s, e in dev[1:]:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
    # sweep the idle stretches and the ranges' boundaries in time order;
    # the innermost open range is the latest-started one
    points = sorted({p for g in gaps for p in g} | {p for s, e, _n in ranges for p in (s, e)})
    out: dict = {}
    opened = []  # ranges started by the current point, by start
    i = g = 0
    for a, b in zip(points, points[1:]):
        while i < len(ranges) and ranges[i][0] <= a:
            opened.append(ranges[i])
            i += 1
        opened = [r for r in opened if r[1] > a]
        while g < len(gaps) and gaps[g][1] <= a:
            g += 1
        if g < len(gaps) and gaps[g][0] <= a:
            owner = opened[-1][2] if opened else None
            out[owner] = out.get(owner, 0.0) + (b - a) * 1e-6
    return out


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
