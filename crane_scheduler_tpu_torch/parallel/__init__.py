from .step import (
    COMPACT_MAX_PODS,
    PackedFetch,
    PreparedSnapshot,
    ScheduleStep,
    StepResult,
)

__all__ = [
    "COMPACT_MAX_PODS",
    "PackedFetch",
    "PreparedSnapshot",
    "ScheduleStep",
    "StepResult",
]
