"""Load-aware descheduler: the correcting half of the placement loop.

Counterpart of ``crane_scheduler_tpu/descheduler/__init__.py``.

The annotator writes per-node load annotations, the Dynamic plugin
places against them — and nothing ever corrects a placement that
turned hot. This package closes the loop in the crane-descheduler
mold: sustained-hotspot detection from the same ``value,timestamp``
annotations the plugin reads, victim selection behind safety gates,
and evictions through the cluster mirror's ``evict_pod``. Host Python
throughout: the device work of the loop is the scheduler that
re-places the evictees.
"""

from .config import DEFAULT_WATERMARKS, DeschedulerConfig, WatermarkPolicy
from .descheduler import CycleReport, Eviction, LoadAwareDescheduler

__all__ = [
    "WatermarkPolicy",
    "DeschedulerConfig",
    "DEFAULT_WATERMARKS",
    "LoadAwareDescheduler",
    "CycleReport",
    "Eviction",
]
