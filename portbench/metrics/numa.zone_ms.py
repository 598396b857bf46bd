"""Ms per dispatched drip window in ``drip_zone`` of the port's stage clock
(the NRT window's zone results, their annotation writes and assumes),
over the untraced window; None where the port has no such stage."""

from portbench.readers import stage_ms


def read(obs):
    return stage_ms(obs, "drip_zone")
