from .scheduler import BatchResult, BatchScheduler, BurstResult

__all__ = ["BatchResult", "BatchScheduler", "BurstResult"]
