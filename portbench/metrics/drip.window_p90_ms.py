"""Host wall ms per drip window, the 90th percentile over the measured
window."""

from portbench.readers import quantile_ms


def read(obs):
    return quantile_ms(obs, 0.9)
