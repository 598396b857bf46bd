"""Ms per dispatched drip window in ``drip_bind`` of the port's stage clock
(lifecycle marks and ``ClusterState.bind_pods``), over the untraced
window."""

from portbench.readers import stage_ms


def read(obs):
    return stage_ms(obs, "drip_bind")
