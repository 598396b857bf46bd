"""Ms per dispatched drip window in ``drip_prepare`` of the port's stage
clock (column refresh, the request matrix, column puts and uploads), over
the untraced window."""

from portbench.readers import stage_ms


def read(obs):
    return stage_ms(obs, "drip_prepare")
