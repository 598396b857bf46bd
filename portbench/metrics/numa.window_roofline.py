"""The NRT drip window's least time (bounds_numa.numa_window_least_s) over
its device seconds per window in the profiled stretch, in %."""

from portbench import bounds_numa
from portbench.readers import per_call


def read(obs):
    busy = per_call(obs, "busy_s")
    zones = obs.get("zones")
    if not busy or not zones:
        return None
    return 100.0 * bounds_numa.numa_window_least_s(obs["n"], obs["window_k"], zones) / busy
