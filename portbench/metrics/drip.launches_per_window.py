"""Device kernels per drip window, from the profiled stretch."""

from portbench.readers import per_call


def read(obs):
    return per_call(obs, "kernels")
