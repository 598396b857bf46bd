"""Ms per dispatched drip window in ``drip_admit`` of the port's stage clock
(the queue loop from a window's end, or the call's start, to the next
window's start), over the untraced window."""

from portbench.readers import stage_ms


def read(obs):
    return stage_ms(obs, "drip_admit")
