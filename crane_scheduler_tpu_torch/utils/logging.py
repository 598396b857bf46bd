"""Leveled ``[crane]``-prefixed logging.

Copy of ``crane_scheduler_tpu/utils/logging.py``.

The reference logs its hot paths through klog verbosity levels with a
``[crane]`` message prefix (ref: pkg/plugins/dynamic/plugins.go:59,64 —
``klog.V(4).Infof("[crane] ...")``): a default run is QUIET, and
per-cycle diagnostics only appear when the operator raises verbosity.
This module is that convention for the rebuild: ``vlog(level, msg)``
prints ``[crane] msg`` to stderr iff the process verbosity is >= level.

Levels follow the klog habit loosely:
  1 — per-sweep / lifecycle summaries (one line per annotator sync,
      per bind flush window)
  2 — per-cycle scheduling summaries (one line per batch/burst cycle)
  3 — per-pod decisions (drip mode; the plugins.go:59,64 analogue)

Verbosity comes from ``-v``-style CLI flags (``set_verbosity``) or the
``CRANE_VERBOSITY`` env var; the default is 0 (silent). The check is a
plain int compare so a disabled vlog costs nothing measurable on the
hot path.
"""

from __future__ import annotations

import os
import sys

_level = 0
try:
    _level = int(os.environ.get("CRANE_VERBOSITY", "0") or 0)
except ValueError:
    _level = 0


def set_verbosity(level: int) -> None:
    """Set the process verbosity (CLI ``-v`` flags land here)."""
    global _level
    _level = int(level)


def verbosity() -> int:
    return _level


def vlog(level: int, msg: str) -> None:
    """Print ``[crane] msg`` to stderr iff verbosity >= ``level``."""
    if _level >= level:
        print(f"[crane] {msg}", file=sys.stderr, flush=True)
