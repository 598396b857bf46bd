"""Share of a drip window in which no operation ran on the device, in %:
the device seconds per window from the profiled stretch over the mean
untraced window's wall seconds. (The profiler stretches each window's host
side about twofold; the device's own seconds it leaves as they are.)"""

from portbench.readers import mean_call_s, per_call


def read(obs):
    busy = per_call(obs, "busy_s")
    wall = mean_call_s(obs)
    if not busy or not wall:
        return None
    return 100.0 * (1.0 - busy / wall)
