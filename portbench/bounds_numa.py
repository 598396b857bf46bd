"""The least time of the NRT drip window's work (``numa-drip-65k``), on the
card's peaks in ``bounds``. Counted as ``bounds.drip_window_least_s``
counts the plain window: each input byte read once, each output byte
written once, and the operations these inputs need."""

from __future__ import annotations

from .bounds import INT32_OPS_PER_S, _least


def numa_window_least_s(n: int, k: int, z: int) -> float:
    """One NRT window of ``k`` dependent pods over ``n`` nodes of ``z``
    zones. In: the plain window's node columns (verdict, int64 weighted
    score, bounded flag, int64 free [4]), the zone columns (int64
    allocatable and whole cores [z], three flags: CR, Static, single-NUMA)
    and the zone carry (int64 [z]), the pods' int64 requests [4] and rows
    [5 + z]. Out: per pod the node, feasible, tie and empty-pack counts
    and the takes [z], and both carries folded. Per pod and node: the
    plain window's 10 int64 operations, 10 for the NRT filter, the score
    and the argmax's input, and 10 per zone for the pack (free CPU, the
    fit compare, the order, the capacity, the take, the remainder, the
    count), each int64 operation counted as two int32 ones."""
    nbytes = (n * (1 + 8 + 1 + 32 + 2 * 8 * z + 3 + 8 * z) + k * (32 + 8 * (5 + z))
              + k * 8 * (4 + z) + n * (32 + 8 * z))
    ops = 2 * (20 + 10 * z) * n * k
    return _least(nbytes, ops, INT32_OPS_PER_S)
