"""Ms per dispatched drip window in ``drip_wait`` of the port's stage clock
(the fetch: the device-to-host copy and the event wait), over the untraced
window."""

from portbench.readers import stage_ms


def read(obs):
    return stage_ms(obs, "drip_wait")
