"""Ms per dispatched drip window in ``drip_launch`` of the port's stage clock
(the host's enqueue of the window's K steps: a graph launch, or a shape's
capture), over the untraced window."""

from portbench.readers import stage_ms


def read(obs):
    return stage_ms(obs, "drip_launch")
