"""Stage clock of a repeated host loop, and the profiler-range switch.

A ``StageClock`` splits each pass of a loop (one drip window) into named
stages with one clock reading per boundary, and feeds the same readings
to up to three sinks:

- ``seconds``: total seconds per stage name, always kept;
- a ``SpanRecorder`` (telemetry on): one span per stage, named as the
  stage, on the recorder's own clock (the stage clock reads it);
- ``torch.profiler`` (``profiler_ranges()`` on): one ``record_function``
  range per stage, opened and closed as the stage runs, so the stages
  land in the profiler's trace on its clock, over the device's kernels.

The switch is process-wide, as a profiler session is: ``profiler_ranges()``
turns it on for a block, and ``utils.profiling.torch_trace`` does so around
its trace. A profiler session started without it records none of the
program's ranges (a reduction that counts the session's device events then
sees only the program's device work). ``telemetry.maybe_span`` honours the
same switch, so every span of the port lands in the trace as well.
"""

from __future__ import annotations

import contextlib
import time

RANGES = False  # read once per span or stage; set only by profiler_ranges()


@contextlib.contextmanager
def profiler_ranges():
    """Open a ``torch.profiler.record_function`` range for every span and
    stage of the port inside the block."""
    global RANGES
    prev, RANGES = RANGES, True
    try:
        yield
    finally:
        RANGES = prev


def open_range(name: str):
    from torch.autograd.profiler import record_function

    r = record_function(name)
    r.__enter__()
    return r


@contextlib.contextmanager
def ranged(telemetry, name: str, args: dict):
    """``maybe_span`` with the switch on: a profiler range, around the
    telemetry span when telemetry is on."""
    r = open_range(name)
    try:
        if telemetry is None:
            yield
        else:
            with telemetry.spans.span(name, **args):
                yield
    finally:
        r.__exit__(None, None, None)


class StageClock:
    """One open stage at a time; ``begin``, ``split`` and ``stop`` mark
    its boundaries. ``spans``: a ``SpanRecorder`` to record each stage in
    (its clock becomes this clock's), or None."""

    def __init__(self, names, spans=None):
        self.seconds = dict.fromkeys(names, 0.0)
        self._spans = spans
        self.clock = time.perf_counter if spans is None else spans._clock
        self._name = None
        self._start = 0.0
        self._range = None

    def begin(self, name: str, t: float | None = None) -> float:
        """Open ``name`` at reading ``t`` (read now when None). A stage
        still open (a pass that raised) is dropped unbooked."""
        if t is None:
            t = self.clock()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        self._name, self._start = name, t
        if RANGES:
            self._range = open_range(name)
        return t

    def stop(self) -> float:
        """Close the open stage, if any, at a reading taken now; returns
        the reading."""
        t = self.clock()
        name = self._name
        if name is not None:
            self._name = None
            self.seconds[name] += t - self._start
            if self._range is not None:
                self._range.__exit__(None, None, None)
                self._range = None
            if self._spans is not None:
                self._spans.record(name, self._start, t)
        return t

    def split(self, name: str) -> float:
        """Close the open stage and open ``name`` at the same reading."""
        return self.begin(name, self.stop())
