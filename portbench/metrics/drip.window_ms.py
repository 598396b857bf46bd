"""Host wall ms per drip window (one schedule_queue call of W pods), the
median over the measured window."""

from portbench.readers import quantile_ms


def read(obs):
    return quantile_ms(obs, 0.5)
