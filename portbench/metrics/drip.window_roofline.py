"""The drip window's least time (bounds.drip_window_least_s) over its
device seconds per window in the profiled stretch, in %."""

from portbench import bounds
from portbench.readers import per_call


def read(obs):
    busy = per_call(obs, "busy_s")
    if not busy:
        return None
    return 100.0 * bounds.drip_window_least_s(obs["n"], obs["window_k"]) / busy
