"""The cluster simulator (counterpart of ``crane_scheduler_tpu/sim``)."""

from .simulator import SimClock, Simulator, SimConfig

__all__ = ["SimClock", "Simulator", "SimConfig"]
