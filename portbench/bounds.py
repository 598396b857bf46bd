"""Peaks of the card and the least time of the drip window's work.

The peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity) at
its full 700 W. The window's bytes count each input byte read once and
each output byte written once, whatever the implementation reads again.
A roofline share is ``least time / measured device time``.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
# 64 INT32 lanes per SM x 132 SMs x 1.98 GHz, a multiply-add counted as two
INT32_OPS_PER_S = 33.5e12


def _least(nbytes: float, ops: float, ops_per_s: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def drip_window_least_s(n: int, k: int) -> float:
    """One drip window of ``k`` dependent pods over ``n`` nodes: the node
    columns (verdict, int64 weighted score, bounded flag, int64 free [4])
    and the pods' int64 requests [4] in; each pod's node, feasible count
    and tie count (int64) and the folded free column out. Per pod and
    node: 4 capacity compares, the mask and the running maximum, about 10
    int64 ops, counted as 20 int32 ops."""
    nbytes = n * (1 + 8 + 1 + 32) + k * 32 + k * 3 * 8 + n * 32
    ops = 20 * n * k
    return _least(nbytes, ops, INT32_OPS_PER_S)
