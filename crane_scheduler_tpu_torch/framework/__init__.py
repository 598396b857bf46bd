from .scheduler import (
    BatchResult,
    BatchScheduler,
    BurstResult,
    DripQueue,
    ScheduleResult,
    Scheduler,
)

__all__ = [
    "BatchResult",
    "BatchScheduler",
    "BurstResult",
    "DripQueue",
    "ScheduleResult",
    "Scheduler",
]
