"""Gang (burst) scheduling: batched top-k with hot-value feedback.

Counterpart of ``crane_scheduler_tpu/scorer/topk.py``: the numpy helpers
and the drip path's ``SegMaxTree`` are copies; ``GangScheduler`` is
PyTorch, and its dense level totals go through ``gang_kernel.gang_totals``
(the CUDA kernel on CUDA tensors).

The reference scheduler places one pod per cycle: Filter, Score, pick the
best node (ref: k8s scheduleOne; the Dynamic score is pod-independent).
Within one annotator sync window the node scores don't change, so a naive
burst of P pods piles onto the argmax node — the hotspot problem the
``node_hot_value`` penalty exists to mitigate at sync granularity
(ref: pkg/plugins/dynamic/plugins.go:89-91, pkg/controller/annotator/
node.go:113-121). For gang scheduling we apply the reference's own
correction *inside the batch*:

    After a node receives c in-batch pods, its effective score is
        eff_n(c) = clamp(S_n - 10 * h(c), 0, 100)
        h(c)     = Σ_p  floor(c / count_p)          (hotValue policy)
    i.e. the hot-value formula applied to the batch-local bindings
    (all in-batch bindings fall inside every hotValue window).

**Sequential semantics (the oracle)**: pods are placed one at a time on
the current max-``eff`` schedulable node, ties broken by lowest node
index (the reference randomizes among ties; we fix determinism), skipping
nodes at capacity.

**Batched equivalent (water-filling)**: because every node shares the
same penalty staircase h, the sequential greedy is exactly "take the P
most valuable tokens", where node n's t-th token has value
``max(S_n - 10·h(t), 0)`` and equal-valued tokens order by node index.
Scores are integers in [0,100], so allocation reduces to 101 discrete
levels: count each node's tokens per level, find the waterline level
where cumulative capacity crosses P, and split the waterline level by
prefix-sum in node-index order. Everything is O(101·N) tensor work — no
sequential loop over pods — and shards over the node axis.

**Combined-score mode**: the scheduler framework sums weighted plugin
scores (deploy configs: Dynamic weight 3, NodeResourceTopologyMatch
weight 2 — ref: deploy/manifests/*/scheduler-config.yaml). Only the
Dynamic component moves with in-batch assignments; other plugins'
scores are pod-independent within a burst of identical pods. So token
values generalize to

    value_n(t) = dynamic_weight * max(S_n - 10·h(t), 0) + offset_n

with ``offset_n = Σ_other w_i·score_i(n)`` a per-node constant. The
level grid widens to [0, 100·dynamic_weight + max_offset] and the
per-level token count inverts through the same g staircase:
``A_n(L) = k_cap`` when L <= offset_n, else ``min(k_cap, g[(S_n-q)//10])``
with ``q = ceil((L-offset_n)/dynamic_weight)`` (0 when q > 100 or
S_n < q). Defaults (weight 1, offsets 0) reproduce the plain grid.

**Sparse level grid**: the dense grid scans every integer level in
[0, 100·w + max_offset + 1] — 5,102 levels for an exotic
``dynamic_weight=50`` config. But the waterline L* (the highest level
whose cumulative token count covers P) can only land on an *achievable
token value* ``w·d + offset_n`` (d in 0..100), on level 0, or on the
grid top (the empty-batch sentinel): totals(L) is piecewise-constant
between achievable values, so the max L with totals(L) >= P is always
an interval right-endpoint = an achievable value. ``candidate_levels``
builds that set from the offsets actually present (101·|distinct
offsets| + 2 entries, padded to a lane multiple to bound recompiles)
and the solver evaluates totals only there — bit-identical results,
O(101·|offsets|·N) instead of O(100·w·N) work.

Entries with ``count <= 0`` are skipped in h (the reference would panic
on integer division by zero; a policy that does this is invalid).
"""


from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from ..constants import MAX_NODE_SCORE
from ..device import resolve_device
from ..utils.score import normalize_score
from .gang_kernel import a_table, gang_totals

# "unbounded tokens at this level" — kept int32-safe (the solver is int32).
_INF_TOKENS = np.int64(1) << 30


def hot_penalty_steps(hv_counts: Sequence[int]) -> np.ndarray:
    """g[x] = min assignments c such that h(c) > x, for x = 0..10.

    h(c) = Σ_p floor(c / count_p). g bounds how many pods a node can take
    before its score drops by more than 10*x. When no (valid) hotValue
    entries exist, h == 0 and every g[x] is unbounded.
    """
    counts = [int(c) for c in hv_counts if int(c) > 0]
    g = np.full((11,), _INF_TOKENS, dtype=np.int64)
    if not counts:
        return g
    # h increases by >= 1 at least every min(counts) steps, so h(c) > 10
    # within c <= 11 * min(counts).
    limit = 11 * min(counts) + 1
    h = np.zeros((limit,), dtype=np.int64)
    for c in range(limit):
        h[c] = sum(c // k for k in counts)
    for x in range(11):
        above = np.nonzero(h > x)[0]
        if len(above):
            g[x] = above[0]
    return g


def candidate_levels(
    dynamic_weight: int,
    max_offset: int,
    offsets,
    n_levels: int,
) -> np.ndarray | None:
    """Sparse waterline candidates (see module docstring): achievable
    token values ``w·d + o`` over the distinct offsets present, plus
    level 0 (the full-capacity total lives there) and the grid top
    (``num_pods == 0`` sentinel). Sorted ascending with ``levels[0] ==
    0``; padded to a multiple of 128 with the top value so the jit
    specializes per size bucket, not per offset multiset. Returns None
    when the dense grid is at least as small (e.g. plain mode: 101
    distinct values vs 102 dense levels)."""
    w = int(dynamic_weight)
    uniq = np.unique(np.clip(np.asarray(offsets, np.int64), 0, int(max_offset)))
    if 101 * len(uniq) + 2 >= n_levels:
        return None
    d = np.arange(MAX_NODE_SCORE + 1, dtype=np.int64) * w
    cand = np.unique(np.concatenate([
        np.zeros((1,), np.int64),
        (d[:, None] + uniq[None, :]).ravel(),
        np.asarray([n_levels - 1], np.int64),
    ]))
    if len(cand) >= n_levels:
        return None
    pad = (-len(cand)) % 128
    if pad:
        cand = np.concatenate([cand, np.full((pad,), n_levels - 1, np.int64)])
    return cand.astype(np.int32)


def waterline_take(exact, remainder, order=None) -> np.ndarray:
    """Split ``remainder`` waterline tokens across the nodes holding
    ``exact`` tokens at L*. Default (``order=None``) is the sequential
    oracle's rule — node-index prefix order, exactly the ``cumsum``
    split the solver jits. ``order`` (a permutation of node indices)
    fills greedily in that order instead: the gang queue's
    fragmentation-aware / seeded tie policies reorder ONLY this split —
    the waterline level, the token multiset, and every count away from
    L* are policy-independent by construction."""
    exact = np.asarray(exact)
    if order is None:
        prefix = np.cumsum(exact) - exact
        return np.clip(remainder - prefix, 0, exact)
    take = np.zeros_like(exact)
    ex = exact[order]
    prefix = np.cumsum(ex) - ex
    take[order] = np.clip(remainder - prefix, 0, ex)
    return take


@dataclass
class GangResult:
    counts: Any  # [N] int32 — pods assigned per node
    unassigned: Any  # scalar int — pods that found no capacity
    waterline: Any  # scalar int — the score level where allocation stopped


def gang_assign_oracle(
    scores: Sequence[int],
    schedulable: Sequence[bool],
    num_pods: int,
    hv_counts: Sequence[int],
    capacity: Sequence[int] | None = None,
    offsets: Sequence[int] | None = None,
    dynamic_weight: int = 1,
    max_offset: int | None = None,
    prior: Sequence[int] | None = None,
) -> GangResult:
    """Sequential greedy reference implementation (slow; parity oracle).

    ``waterline`` follows the solver's convention: the effective value of
    the least valuable token taken (== the solver's L*, the highest level
    whose cumulative token count covers ``num_pods``); -1 when capacity
    runs short; the grid top (``100*w + max_offset + 1``) when no pod was
    requested. ``max_offset`` should match the solver's static bound
    (defaults to max(offsets)).

    ``prior`` (per node) counts in-batch assignments made by an earlier
    pass: the hot-penalty staircase continues at h(prior + t) while
    ``capacity`` still bounds only this pass's assignments.
    """
    n = len(scores)
    counts = [int(c) for c in hv_counts if int(c) > 0]
    cap = [num_pods] * n if capacity is None else [int(c) for c in capacity]
    offs = [0] * n if offsets is None else [int(o) for o in offsets]
    base = [0] * n if prior is None else [int(p) for p in prior]
    w = int(dynamic_weight)
    if max_offset is None:
        max_offset = max(offs, default=0)
    assigned = [0] * n

    def h(c: int) -> int:
        return sum(c // k for k in counts)

    unassigned = 0
    min_eff: int | None = None
    for _ in range(num_pods):
        best, best_eff = -1, -1
        for i in range(n):
            if not schedulable[i] or assigned[i] >= cap[i]:
                continue
            dyn = normalize_score(
                int(scores[i]) - 10 * h(base[i] + assigned[i]), MAX_NODE_SCORE, 0
            )
            eff = w * dyn + offs[i]
            if eff > best_eff:
                best, best_eff = i, eff
        if best < 0:
            unassigned += 1
            continue
        assigned[best] += 1
        min_eff = best_eff if min_eff is None else min(min_eff, best_eff)
    if unassigned > 0:
        waterline = -1
    elif min_eff is None:  # num_pods == 0: nothing constrains the level
        waterline = MAX_NODE_SCORE * w + int(max_offset) + 1
    else:
        waterline = min_eff
    return GangResult(np.array(assigned, np.int32), unassigned, waterline)


def gang_assign_host(
    scores,
    schedulable,
    num_pods: int,
    hv_counts: Sequence[int],
    capacity=None,
    offsets=None,
    dynamic_weight: int = 1,
    max_offset: int = 0,
    prior=None,
    tie_order=None,
) -> GangResult:
    """Vectorized numpy twin of ``GangScheduler._assign_impl``.

    Same water-filling math (level table, waterline search, node-order
    prefix split) with the same int32-range clipping, so results are
    bit-identical to the device solver — fast enough to verify placements
    at benchmark scale (O(levels*N) numpy) without a device round-trip.

    ``prior`` shifts each node's hot-penalty staircase past assignments
    an earlier pass already made (token t is valued at h(prior + t));
    ``capacity`` bounds this pass only.

    ``tie_order`` is the gang queue's waterline-split policy hook:
    ``tie_order(exact, upper, l_star) -> order | None`` may return a
    node-index permutation for ``waterline_take``. None (default, and a
    None return) keeps the oracle's node-index prefix split.
    """
    s = np.asarray(scores, np.int64)
    n = s.shape[0]
    w = int(dynamic_weight)
    g = hot_penalty_steps(hv_counts)  # [11] int64 (values <= 2^30)
    num_pods = int(min(int(num_pods), 2**31 - 1))
    if capacity is None:
        capacity = np.full((n,), num_pods, dtype=np.int64)
    capacity = np.clip(np.asarray(capacity, np.int64), 0, 2**31 - 1)
    if offsets is None:
        offsets = np.zeros((n,), dtype=np.int64)
    offs = np.clip(np.asarray(offsets, np.int64), 0, int(max_offset))
    if prior is None:
        prior = np.zeros((n,), dtype=np.int64)
    prior = np.clip(np.asarray(prior, np.int64), 0, 2**31 - 1)
    n_levels = MAX_NODE_SCORE * w + int(max_offset) + 2

    k_cap = np.where(np.asarray(schedulable, bool), capacity, 0)
    k_cap = np.minimum(k_cap, max(num_pods, 0))
    k_cap = np.minimum(k_cap, (2**31 - 1) // max(n, 1))

    def a_table(lv):
        """A_n(L) for lv broadcastable against the node axis."""
        qnum = lv - offs
        q = (qnum + (w - 1)) // w
        xq = np.clip((s - q) // 10, 0, 10)
        unlocked = np.where((q <= MAX_NODE_SCORE) & (s >= q), g[xq], 0)
        unlocked = np.maximum(unlocked - prior, 0)  # tokens an earlier pass took
        unlocked = np.where(qnum <= 0, k_cap, unlocked)
        return np.minimum(k_cap, unlocked)

    levels = np.arange(n_levels, dtype=np.int64)
    totals = a_table(levels[:, None]).sum(axis=1)  # [n_levels]
    meets = np.nonzero(totals >= num_pods)[0]
    l_star = int(meets.max()) if len(meets) else -1

    if l_star < 0:  # capacity short: everything binds, rest unassigned
        counts = k_cap
        return GangResult(
            counts.astype(np.int32), int(num_pods - totals[0]), -1
        )
    upper = a_table(np.int64(l_star + 1)) if l_star + 1 < n_levels else np.zeros_like(k_cap)
    at_or_above = a_table(np.int64(l_star))
    exact = at_or_above - upper
    if l_star + 1 >= n_levels:
        remainder = num_pods
    else:
        remainder = num_pods - int(totals[l_star + 1])
    order = None if tie_order is None else tie_order(exact, upper, l_star)
    take = waterline_take(exact, remainder, order)
    counts = upper + take
    return GangResult(counts.astype(np.int32), 0, l_star)


class GangScheduler:
    """Water-filling gang assignment on one device.

    Static over (policy hotValue table, dynamic_weight, max_offset);
    ``num_pods``, per-node capacity and per-node combined-score offsets
    are call inputs. Defaults (``dynamic_weight=1``, ``max_offset=0``,
    zero offsets) are the plain Dynamic-score domain. ``_assign_impl``
    stays on the device end to end (no host sync between the level
    totals and the waterline split).
    """

    def __init__(
        self,
        hv_counts: Sequence[int],
        dynamic_weight: int = 1,
        max_offset: int = 0,
        device=None,
    ):
        if dynamic_weight < 1:
            raise ValueError("dynamic_weight must be >= 1")
        if max_offset < 0:
            raise ValueError("max_offset must be >= 0")
        self.device = resolve_device(device)
        self._g_host = hot_penalty_steps(hv_counts)  # [11] np.int64
        self._g = torch.tensor(self._g_host.astype(np.int32), device=self.device)
        self._weight = int(dynamic_weight)
        self._max_offset = int(max_offset)
        # token values live in [0, 100*w + max_offset]; one extra level so
        # waterline+1 indexing stays in range
        self._n_levels = MAX_NODE_SCORE * self._weight + self._max_offset + 2

    def __call__(
        self, scores, schedulable, num_pods, capacity=None, offsets=None,
        prior=None, sparse_levels: bool | None = None,
    ) -> GangResult:
        """Host-level call: numpy/sequence inputs, numpy counts out.
        ``sparse_levels``: True forces the sparse candidate grid, False
        the dense one, None picks whichever is smaller for these offsets
        (results are identical either way)."""
        scores = np.asarray(scores, dtype=np.int32)
        n = scores.shape[0]
        num_pods = int(min(int(num_pods), 2**31 - 1))
        if capacity is None:
            capacity = np.full((n,), num_pods, dtype=np.int64)
        capacity = np.minimum(np.asarray(capacity, dtype=np.int64), 2**31 - 1)
        if offsets is None:
            offsets = np.zeros((n,), dtype=np.int32)
        if prior is None:
            prior = np.zeros((n,), dtype=np.int32)
        levels = None
        if sparse_levels or sparse_levels is None:
            levels = candidate_levels(
                self._weight, self._max_offset, offsets, self._n_levels
            )
            if levels is None and sparse_levels:
                # forced sparse on a config where dense is smaller:
                # honor it anyway (parity testing hook)
                uniq = np.unique(
                    np.clip(np.asarray(offsets, np.int64), 0, self._max_offset)
                )
                d = np.arange(MAX_NODE_SCORE + 1, dtype=np.int64) * self._weight
                levels = np.unique(np.concatenate([
                    np.zeros((1,), np.int64),
                    (d[:, None] + uniq[None, :]).ravel(),
                    np.asarray([self._n_levels - 1], np.int64),
                ])).astype(np.int32)

        def put(a, dt):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(self.device)

        counts, unassigned, waterline = self._assign_impl(
            put(scores, np.int32),
            put(schedulable, bool),
            num_pods,
            put(np.clip(capacity, -(2**31), 2**31 - 1), np.int32),
            put(np.asarray(offsets, np.int64).clip(-(2**31), 2**31 - 1), np.int32),
            put(np.asarray(prior, np.int64).clip(-(2**31), 2**31 - 1), np.int32),
            None if levels is None else put(levels, np.int32),
        )
        return GangResult(counts.cpu().numpy(), int(unassigned), int(waterline))

    def _a_table(self, s, offsets, k_cap, prior, lv):
        return a_table(s, offsets, k_cap, prior, lv, self._g, self._weight)

    def _totals(self, s, offs, k_cap, pri):
        """totals[L] = Σ_n A_n(L) over the dense grid (the CUDA kernel on
        CUDA tensors, the materialized table on the CPU)."""
        return gang_totals(s, offs, k_cap, pri, self._g, self._weight, self._n_levels)

    def _assign_impl(self, scores, schedulable, num_pods: int, capacity,
                     offsets, prior, levels=None):
        """Device tensors in, ``(counts int32 [N], unassigned, waterline)``
        (0-dim int32 tensors) out. All arithmetic is int32, exact because
        per-node tokens are clipped to (2^31-1)/N so every level total
        fits. ``levels=None`` scans the dense grid through ``_totals``; a
        ``candidate_levels`` array scans only achievable token values.

        The solve runs in three phases, which ``parallel.sharded`` runs
        once per node tile with the combines between them done across
        tiles: tile-local clipped inputs and level totals
        (``_tile_inputs``, ``_tile_totals``); one global combine, the
        waterline ``l_star`` from the summed totals (``_waterline``) and
        the remainder from the summed ``upper``; tile-local counts, whose
        node-order prefix starts at the tile's offset (``_tile_counts``)."""
        num_pods = min(int(num_pods), 2**31 - 1)
        s, offs, k_cap, pri = self._tile_inputs(
            scores, schedulable, num_pods, capacity, offsets, prior, scores.shape[0]
        )
        if levels is not None:
            levels = levels.to(torch.int32)  # [C], levels[0] == 0
        totals = self._tile_totals(s, offs, k_cap, pri, levels)
        if levels is None:
            levels = torch.arange(self._n_levels, dtype=torch.int32, device=s.device)
        l_star = self._waterline(totals, levels, num_pods)
        upper, exact = self._tile_upper_exact(s, offs, k_cap, pri, l_star)
        # sum(upper) == totals(L* + 1) exactly (int32 sums)
        remainder = num_pods - upper.sum(dtype=torch.int32)
        counts = self._tile_counts(k_cap, upper, exact, remainder, 0, l_star)
        unassigned, waterline = self._outcome(totals, l_star, num_pods)
        return counts, unassigned, waterline

    # -- the solve's phases ------------------------------------------------

    def _tile_inputs(self, scores, schedulable, num_pods: int, capacity, offsets,
                     prior, n_global: int):
        """Phase 1, tile-local: the clipped int32 ``(s, offs, k_cap, pri)``.
        The token clip ``(2^31-1) // N`` takes the global row count
        ``n_global`` (the reference's GSPMD program sees the global
        array), never the tile's own."""
        capacity = torch.clamp(capacity, 0, 2**31 - 1).to(torch.int32)
        k_cap = torch.where(schedulable, capacity, 0)
        # no node ever needs more than num_pods tokens; the second clip
        # keeps the level-total reductions within int32
        k_cap = torch.clamp(k_cap, max=max(num_pods, 0))
        k_cap = torch.clamp(k_cap, max=(2**31 - 1) // max(int(n_global), 1)).contiguous()
        s = scores.to(torch.int32).contiguous()
        offs = torch.clamp(offsets.to(torch.int32), 0, self._max_offset).contiguous()
        pri = torch.clamp(prior.to(torch.int32), 0, 2**31 - 1).contiguous()
        return s, offs, k_cap, pri

    def _tile_totals(self, s, offs, k_cap, pri, levels=None):
        """Phase 1, tile-local: the level totals over ``levels``; None is the
        dense grid (one K2 launch on CUDA tensors)."""
        if levels is None:
            return self._totals(s, offs, k_cap, pri)  # [n_levels]
        return self._a_table(
            s[None, :], offs[None, :], k_cap[None, :], pri[None, :], levels[:, None],
        ).sum(dim=1, dtype=torch.int32)

    @staticmethod
    def _waterline(totals, levels, num_pods: int):
        """Phase 2, global: ``l_star`` over the totals of every node (-1:
        capacity short)."""
        meets = totals >= num_pods  # True for L <= L*
        return torch.where(meets, levels, -1).max()

    def _tile_upper_exact(self, s, offs, k_cap, pri, l_star):
        """Phase 3, tile-local: tokens above ``l_star`` and exactly at it.
        Both outcomes are computed and selected on the device (the
        reference branches with lax.cond); with capacity short the
        waterline side runs at level 0 and is discarded."""
        l_at = torch.clamp(l_star, min=0)
        upper = torch.where(
            l_at + 1 >= self._n_levels, 0, self._a_table(s, offs, k_cap, pri, l_at + 1)
        )
        at_or_above = self._a_table(s, offs, k_cap, pri, l_at)
        return upper, at_or_above - upper

    @staticmethod
    def _tile_counts(k_cap, upper, exact, remainder, offset, l_star):
        """Phase 3, tile-local: counts per node. ``offset`` is the exclusive
        sum of ``exact`` over the earlier tiles (0 for one tile), so the
        node-order prefix runs on across tiles; int32 pinned."""
        prefix = offset + torch.cumsum(exact, dim=0, dtype=torch.int32) - exact
        take = torch.minimum(torch.clamp(remainder - prefix, min=0), exact)
        return torch.where(l_star < 0, k_cap, upper + take).to(torch.int32)

    @staticmethod
    def _outcome(totals, l_star, num_pods: int):
        """``(unassigned, waterline)``: 0-dim int32. ``totals[0]`` counts
        every token (``levels[0] == 0`` in both grids)."""
        short = l_star < 0
        unassigned = torch.where(short, num_pods - totals[0], 0)
        waterline = torch.where(short, -1, l_star)
        return unassigned.to(torch.int32), waterline.to(torch.int32)


# ---------------------------------------------------------------------------
# Incremental first-argmax: segment-max tree over a masked score column.
# ---------------------------------------------------------------------------

_SEG_MIN = np.int64(np.iinfo(np.int64).min)


class SegMaxTree:
    """Segment-max tree over a masked weighted-score column.

    Copy of ``SegMaxTree`` in ``crane_scheduler_tpu/scorer/topk.py``.

    The drip fast path picks ``argmax(where(mask, weighted, INT64_MIN))``
    per pod — O(n) even when only one node changed since the last pod
    (the previous bind's ``free -= request`` fold). This tree makes the
    common drip cadence O(log n): build once per (column, request-vec)
    pair, then each bind updates exactly the folded leaf.

    Per heap node it keeps ``(max, count-of-max, feasible-count)`` over
    the subtree, which is enough to reproduce every read the scalar
    oracle's selection makes:

    - ``argmax_first()`` — leftmost leaf attaining the root max, i.e.
      exactly ``np.argmax``'s first-maximum rule (snapshot order).
    - ``tie_count`` — how many *feasible* leaves attain the root max:
      the seeded tie-break's ``ties.size`` without materializing ties.
    - ``select_tie(r)`` — the r-th (0-based, snapshot order) leaf
      attaining the root max: ``ties[r]`` without flatnonzero.
    - ``feasible_count`` — ``count_nonzero(mask)``.

    Build is O(n) vectorized (bottom-up level merges); ``update`` is
    O(log n) Python scalars. Infeasible leaves carry ``INT64_MIN`` with
    zero counts, so an all-infeasible (sub)tree reports max=INT64_MIN,
    counts 0 — callers gate on ``feasible_count`` before selecting.
    """

    __slots__ = ("n", "_size", "_mx", "_cnt", "_feas")

    def __init__(self, values: np.ndarray, feasible: np.ndarray):
        """``values``: int64[n], already masked (INT64_MIN where the
        node is infeasible). ``feasible``: bool[n]."""
        n = int(len(values))
        self.n = n
        size = 1 << max(0, n - 1).bit_length() if n > 1 else 1
        self._size = size
        mx = np.full(2 * size, _SEG_MIN, dtype=np.int64)
        cnt = np.zeros(2 * size, dtype=np.int64)
        feas = np.zeros(2 * size, dtype=np.int64)
        mx[size:size + n] = values
        f = feasible.astype(np.int64)
        cnt[size:size + n] = f
        feas[size:size + n] = f
        k = size
        while k > 1:
            k //= 2
            lm, rm = mx[2 * k:4 * k:2], mx[2 * k + 1:4 * k:2]
            lc, rc = cnt[2 * k:4 * k:2], cnt[2 * k + 1:4 * k:2]
            right_wins = rm > lm
            mx[k:2 * k] = np.where(right_wins, rm, lm)
            cnt[k:2 * k] = np.where(
                right_wins, rc, np.where(lm > rm, lc, lc + rc)
            )
            feas[k:2 * k] = feas[2 * k:4 * k:2] + feas[2 * k + 1:4 * k:2]
        self._mx, self._cnt, self._feas = mx, cnt, feas

    @property
    def feasible_count(self) -> int:
        return int(self._feas[1])

    @property
    def max_value(self) -> int:
        return int(self._mx[1])

    @property
    def tie_count(self) -> int:
        """Feasible leaves attaining the root max (0 when none are)."""
        return int(self._cnt[1])

    def argmax_first(self) -> int:
        """Leftmost leaf index attaining the root max — bit-identical to
        ``np.argmax`` over the masked column."""
        mx = self._mx
        m = mx[1]
        i = 1
        size = self._size
        while i < size:
            i *= 2
            if mx[i] != m:
                i += 1
        return i - size

    def select_tie(self, r: int) -> int:
        """Index of the r-th (0-based, ascending) feasible leaf attaining
        the root max — ``np.flatnonzero(ties)[r]`` without the scan."""
        mx, cnt = self._mx, self._cnt
        m = mx[1]
        i = 1
        size = self._size
        while i < size:
            i *= 2
            c = cnt[i] if mx[i] == m else 0
            if r >= c:
                r -= int(c)
                i += 1
        return i - size

    def update(self, i: int, value: int, feasible: bool) -> None:
        """Point update of leaf ``i`` (O(log n)) — the drip fold's only
        column maintenance: re-mask the bound node, leave n-1 alone."""
        mx, cnt, feas = self._mx, self._cnt, self._feas
        j = self._size + int(i)
        f = 1 if feasible else 0
        mx[j] = value if feasible else _SEG_MIN
        cnt[j] = f
        feas[j] = f
        j //= 2
        while j >= 1:
            l, r = 2 * j, 2 * j + 1
            lm, rm = mx[l], mx[r]
            if lm > rm:
                mx[j], cnt[j] = lm, cnt[l]
            elif rm > lm:
                mx[j], cnt[j] = rm, cnt[r]
            else:
                mx[j], cnt[j] = lm, cnt[l] + cnt[r]
            feas[j] = feas[l] + feas[r]
            j //= 2
