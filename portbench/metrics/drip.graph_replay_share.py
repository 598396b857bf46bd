"""Share of the untraced window's dispatched drip windows that the batch
kernel replayed from a captured CUDA graph, in % (``graph_replays`` over
``dispatches``; the rest ran op by op)."""

from portbench.readers import per_window


def read(obs):
    replays = (obs.get("batch") or {}).get("graph_replays")
    return None if replays is None else per_window(obs, 100.0 * replays)
