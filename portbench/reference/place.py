"""Placements by the scheduler's sequential semantics, in NumPy.

- ``drip``: the scheduling queue, one pod at a time (kube-scheduler's
  scheduleOne): Filter (Dynamic verdict and NodeResourcesFit: the pod's
  requests within allocatable minus requested, one pod slot), Score
  (``dynamic_weight`` x the Dynamic score; NodeResourcesFit scores
  nothing here), the best node with ties to the lowest node index, and the
  bind before the next pod.
"""

from __future__ import annotations

import numpy as np

UNBOUNDED = 1 << 30


def copies_that_fit(free, bounded, vec) -> np.ndarray:
    """How many pods of request ``vec`` (int64 [4]: milli-cpu, memory,
    ephemeral, pod slots) fit in each node's ``free`` row; nodes with no
    reported allocatable are unbounded."""
    free = np.clip(np.asarray(free, np.int64), 0, None)
    out = np.full(free.shape[0], UNBOUNDED, dtype=np.int64)
    for d in range(free.shape[1]):
        if vec[d] > 0:
            out = np.minimum(out, free[:, d] // vec[d])
    return np.where(np.asarray(bounded, bool), out, UNBOUNDED)


def drip(schedulable, score, dyn_weight: int, free, bounded, vecs,
         fold: bool = True, window: int = 128) -> tuple[np.ndarray, np.ndarray]:
    """Node index per pod (-1 when nothing fits) for pods with requests
    ``vecs`` [P, 4] in queue order, and the free matrix after their binds.

    Runs of consecutive identical requests are placed together: while the
    weighted scores do not move with binds, one pod after another takes
    the best node with room, so a run fills the nodes in (weighted desc,
    index asc) order, each up to the copies that fit. ``fold=False`` is a
    control: every pod of a ``window`` sees the free state at the window's
    start, as a window that skips its sequential fold would."""
    free = np.array(free, dtype=np.int64)
    vecs = np.asarray(vecs, np.int64)
    weighted = np.asarray(score, np.int64) * int(dyn_weight)
    order = np.lexsort((np.arange(len(weighted)), -weighted))  # score desc, index asc
    order = order[np.asarray(schedulable, bool)[order]]
    out = np.full(len(vecs), -1, dtype=np.int64)
    p = 0
    while p < len(vecs):
        end = len(vecs) if fold else min(len(vecs), (p // window + 1) * window)
        q = p + 1
        while q < end and np.array_equal(vecs[q], vecs[p]):
            q += 1
        vec = vecs[p]
        cap = copies_that_fit(free[order], bounded[order], vec)
        if not fold:
            cap = np.where(cap > 0, UNBOUNDED, 0)  # the window sees no fill
        take = np.minimum(cap, q - p)
        ends = np.cumsum(take)
        got = int(min(ends[-1] if len(ends) else 0, q - p))
        used = int(np.searchsorted(ends, got)) + 1  # the nodes that take the run
        nodes = np.repeat(order[:used], take[:used])[:got]
        out[p:p + got] = nodes
        np.subtract.at(free, nodes, vec)
        p = q
    return out, free
