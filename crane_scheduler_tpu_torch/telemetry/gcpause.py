"""The process's garbage-collector pauses, counted on ``gc.callbacks``.

One counter per process (``GC_PAUSES``), since the collector is one per
process: pause seconds and collections per generation, read from two
``perf_counter`` readings around each collection. ``telemetry.enable()``
(and ``CRANE_TELEMETRY=1``) installs it and exports it as
``crane_gc_pause_seconds_total{generation}`` and
``crane_gc_collections_total{generation}``; ``install``/``uninstall`` work
on their own too. Nothing installs it by default.
"""

from __future__ import annotations

import gc
import time


class GCPauses:
    """Totals per generation (index 0-2). The callback takes no lock: the
    collector runs one collection at a time, under the interpreter lock."""

    def __init__(self):
        self.seconds = [0.0, 0.0, 0.0]
        self.collections = [0, 0, 0]
        self._start = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._start = time.perf_counter()
            return
        gen = info["generation"]
        self.seconds[gen] += time.perf_counter() - self._start
        self.collections[gen] += 1

    @property
    def installed(self) -> bool:
        return any(cb is self for cb in gc.callbacks)

    def install(self) -> bool:
        """Hook the collector; False when already hooked."""
        if self.installed:
            return False
        gc.callbacks.append(self)
        return True

    def uninstall(self) -> None:
        gc.callbacks[:] = [cb for cb in gc.callbacks if cb is not self]

    def export(self, registry) -> None:
        registry.counter_func(
            "crane_gc_pause_seconds_total", "Garbage-collector pause seconds",
            ("generation",), lambda: {(g,): s for g, s in enumerate(self.seconds)})
        registry.counter_func(
            "crane_gc_collections_total", "Garbage-collector collections",
            ("generation",), lambda: {(g,): c for g, c in enumerate(self.collections)})


GC_PAUSES = GCPauses()
