"""Hybrid scorer: float32 speed, float64 placement parity.

Counterpart of ``crane_scheduler_tpu/scorer/hybrid.py``: the risk scan,
the exact f64 re-score, the override vectors (full and incremental, with
the dirty rows of a delta or column upload) and ``HybridScorer``, whose
float32 pass is ``BatchedScorer(torch.float32)`` (on CUDA tensors the
fused kernel ``csrc/score_kernel.cu``). ``ScheduleStep``
(``parallel/step.py``) substitutes the override rows on the device.

The float32 fast path can disagree with the Go semantics only where a
value sits within float32 error of a decision boundary:

- a usage within ~2^-24 of a predicate threshold (filter flip),
- a score quotient within accumulated-rounding error of an integer
  (trunc flip),
- a hot value within error of a multiple of 0.1 (penalty flip).

Those cases are detected by a HOST-side risk scan at snapshot-refresh
time (``risk_mask_f64`` below — numpy over the store columns; a
device-emitted mask was prototyped in round 3 and measured slower than
the host scan once the column-replay refresh landed, see
ROADMAP.md round 3). Risky rows — typically a tiny fraction — are
re-scored exactly in float64 numpy on the host (``score_rows_f64``, the
same IEEE-double operation sequence as the Go code and the oracle, with
no dependency on a device float64 mode), and their verdicts ride the prepared
snapshot as override vectors the device step substitutes. The result is
bit-parity everywhere at f32 throughput.

Tolerances are deliberately loose (1e-4 absolute on comparisons, 1e-3 on
truncation distance for a ≤16-term accumulation of O(100) magnitudes —
orders of magnitude above the true f32 error bounds), trading a few
extra host re-scores for a safety margin.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..constants import (
    HOT_VALUE_ACTIVE_PERIOD_SECONDS,
    MAX_NODE_SCORE,
    MIN_NODE_SCORE,
)
from ..policy.compile import PolicyTensors
from .batched import BatchedScorer

_CMP_TOL = 1e-4  # |usage - threshold| risk window
_TRUNC_TOL = 1e-3  # distance-to-integer risk window for quotients
_GO_MIN_I64 = -(2**63)


def _trunc_f64(q: np.ndarray) -> np.ndarray:
    """Vectorized Go int64(float64) with the amd64 indefinite."""
    out = np.full(q.shape, _GO_MIN_I64, dtype=np.int64)
    ok = np.isfinite(q) & (q > -(2.0**63)) & (q < 2.0**63)
    out[ok] = np.trunc(q[ok]).astype(np.int64)
    return out


def score_rows_f64(
    values: np.ndarray,
    ts: np.ndarray,
    hot_value: np.ndarray,
    hot_ts: np.ndarray,
    now: float,
    tensors: PolicyTensors,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact float64 verdicts for a row subset (IEEE-double, same op
    order as stats.go; bit-identical to the oracle)."""
    n = values.shape[0]
    # filter
    schedulable = np.ones((n,), dtype=bool)
    for p in range(len(tensors.pred_idx)):
        active = tensors.pred_active[p]
        if active <= 0:
            continue
        col = tensors.pred_idx[p]
        threshold = tensors.pred_threshold[p]
        if threshold == 0:
            continue
        u = values[:, col]
        fresh = now < ts[:, col] + active
        with np.errstate(invalid="ignore"):
            ok = fresh & ~(u < 0)
            over = ok & (u > threshold)
        schedulable &= ~over
    # score
    if len(tensors.prio_idx) == 0:
        base = np.zeros((n,), dtype=np.int64)
    else:
        acc = np.zeros((n,), dtype=np.float64)
        for k in range(len(tensors.prio_idx)):
            col = tensors.prio_idx[k]
            active = tensors.prio_active[k]
            u = values[:, col]
            fresh = now < ts[:, col] + active
            with np.errstate(invalid="ignore"):
                ok = (active > 0) & fresh & ~(u < 0)
            contrib = (1.0 - u) * tensors.prio_weight[k] * float(MAX_NODE_SCORE)
            acc = acc + np.where(ok, contrib, 0.0)
        if tensors.weight_sum == 0.0:
            with np.errstate(invalid="ignore"):
                q = np.where(acc == 0.0, np.nan, np.sign(acc) * np.inf)
                q = np.where(np.isnan(acc), np.nan, q)
        else:
            q = acc / tensors.weight_sum
        base = _trunc_f64(q)
    hot_fresh = now < hot_ts + HOT_VALUE_ACTIVE_PERIOD_SECONDS
    with np.errstate(invalid="ignore"):
        hot_ok = hot_fresh & ~(hot_value < 0)
    hv = np.where(hot_ok, hot_value, 0.0)
    penalty = _trunc_f64(hv * 10.0)
    score = (base - penalty).astype(np.int64)  # wraps like Go int64
    score = np.clip(score, MIN_NODE_SCORE, MAX_NODE_SCORE)
    return schedulable, score.astype(np.int32)


@dataclass
class HybridResult:
    schedulable: Any
    scores: Any
    rescored: int  # rows that took the f64 path


def risk_mask_f64(
    tensors: PolicyTensors, values, ts, hot_value, hot_ts, now,
    rebase_age: float = 0.0,
    return_margin: bool = False,
) -> np.ndarray:
    """Host-side exact risk detection (vectorized numpy float64).

    A node is risky when an f32 evaluation *could* flip a decision:
    the exact f64 quantity sits within the f32 rounding band of a
    boundary. Exactly-on-boundary counts as risky too (an f32
    accumulation can land microscopically on the other side), but a
    hot value that is a clean integer or a usage far from its
    threshold is provably safe — which is what keeps the rescore
    fraction tiny on real annotator data.

    ``rebase_age``: |now - epoch| of the device arrays when timestamps
    were rebased at an *earlier* prepare time (parallel.sharded keeps a
    cached snapshot resident and re-scores it at later wall times). The
    device's f32 freshness test then computes fl32(ts-epoch) and
    fl32(now-epoch), whose rounding grows with the age — widen the
    staleness tolerance accordingly or boundary flips go unflagged.

    ``return_margin``: also return a per-row float64 ``margin`` — a
    conservative lower bound on how far ``now`` must move before ANY
    now-dependent bit in this row's scan output (freshness flips,
    staleness-band membership, and therefore also the row's exact f64
    verdict) can change. The incremental rescan skips rows whose clock
    movement stays well inside their margin; every quantity that depends
    on ``now`` does so through a freshness comparison (flip at an
    expiry) or a band test (flip at ``|expiry - now| == tol``), and
    ``tol`` itself drifts with slope <= ~3e-6 per second of ``now``
    (1e-6 from |ts-now|, 2e-6 through ``rebase_age``) — so the margin
    consumer's 2x safety factor (``_MARGIN_SAFETY``) strictly covers the
    drift.
    """
    t = tensors
    n = values.shape[0]
    risk = np.zeros((n,), dtype=bool)
    margin = np.full((n,), np.inf) if return_margin else None

    def fold_margin(expiry, tol, gate):
        # distance from `now` to this term's nearest now-boundary: the
        # freshness flip (at expiry) or the band edges (|e - now| == tol)
        d = np.abs(expiry - now)
        m = np.where(gate, np.minimum(d, np.abs(d - tol)), np.inf)
        if m.ndim == 2:
            m = m.min(axis=1)
        np.minimum(margin, m, out=margin)

    # eps32 ~ 1.2e-7 per rounding; ts-epoch and now-epoch each carry one.
    # 1e-6 per second of age gives ~4x margin over the two roundings.
    age_tol = 1e-6 * 2.0 * abs(float(rebase_age))

    def sign_flip(u):
        # The f32 downcast can flush a tiny negative (e.g. -1e-310) to
        # -0.0, flipping the `u < 0` validity test between the f64 and
        # f32 paths — whole w*100 contributions appear/vanish, far from
        # any truncation boundary. Flag any row where the sign test
        # itself disagrees across precisions.
        return (u < 0) != (u.astype(np.float32) < 0)

    def stale_tol(tstamp, active):
        # The f32 freshness error scales with the operand magnitudes
        # (fl32(ts-now) + fl32(active) carries ~eps32*(|ts-now|+active)
        # of rounding), so an absolute tolerance under-flags long
        # windows (>~2h). eps32 ~ 1.2e-7; 1e-6 gives ~4x margin over
        # the two roundings involved. A missing timestamp (-inf) is
        # exactly stale in both precisions — no risk, tol 0 (a naive
        # formula would yield tol=inf and flag every sparse node,
        # forcing the whole cluster onto the slow f64 path).
        with np.errstate(invalid="ignore"):
            tol = 1e-3 + 1e-6 * (np.abs(tstamp - now) + np.abs(active)) + age_tol
            return np.where(np.isfinite(tstamp), tol, 0.0)

    with np.errstate(invalid="ignore"):
        if len(t.pred_idx):
            u = values[:, t.pred_idx]
            expiry = ts[:, t.pred_idx] + t.pred_active
            fresh = now < expiry
            near = np.abs(u - t.pred_threshold) <= _CMP_TOL
            risk |= np.any(fresh & near & (t.pred_active > 0), axis=1)
            risk |= np.any(sign_flip(u) & fresh & (t.pred_active > 0), axis=1)
            tol = stale_tol(ts[:, t.pred_idx], t.pred_active)
            risk |= np.any(
                (np.abs(expiry - now) <= tol) & (t.pred_active > 0), axis=1
            )
            if return_margin:
                fold_margin(expiry, tol, t.pred_active > 0)
        if len(t.prio_idx):
            u = values[:, t.prio_idx]
            expiry = ts[:, t.prio_idx] + t.prio_active
            fresh = now < expiry
            tol = stale_tol(ts[:, t.prio_idx], t.prio_active)
            if return_margin:
                # fold even when weight_sum == 0: the exact f64 score of
                # a rescued row still depends on these freshness bits
                fold_margin(expiry, tol, t.prio_active > 0)
            if t.weight_sum != 0.0:
                valid = fresh & ~(u < 0) & (t.prio_active > 0)
                risk |= np.any(
                    sign_flip(u) & fresh & (t.prio_active > 0), axis=1
                )
                risk |= np.any(
                    (np.abs(expiry - now) <= tol) & (t.prio_active > 0),
                    axis=1,
                )
                contrib = (1.0 - u) * t.prio_weight * float(MAX_NODE_SCORE)
                masked = np.where(valid, contrib, 0.0)
                acc = masked.sum(axis=1)
                q = acc / t.weight_sum
                finite = np.isfinite(q)
                dist = np.abs(q - np.round(q))
                # f32 accumulation error is bounded by K*eps32 times the
                # magnitude of the partial sums; 1e-5 gives ~25x margin.
                abs_sum = np.abs(masked).sum(axis=1)
                trunc_tol = _TRUNC_TOL * 0.1 + 1e-5 * abs_sum / abs(t.weight_sum)
                risk |= finite & (dist <= trunc_tol)
                risk |= ~finite  # NaN/Inf: let f64 decide the indefinite
        hot_expiry = hot_ts + HOT_VALUE_ACTIVE_PERIOD_SECONDS
        hot_tol = stale_tol(hot_ts, HOT_VALUE_ACTIVE_PERIOD_SECONDS)
        risk |= np.abs(hot_expiry - now) <= hot_tol
        if return_margin:
            fold_margin(hot_expiry, hot_tol, True)
        hot_fresh = now < hot_expiry
        hv = np.where(hot_fresh & ~(hot_value < 0), hot_value, 0.0)
        hp = hv * 10.0
        dist = np.abs(hp - np.round(hp))
        # a clean multiple of 10 (integral hot value) converts to f32
        # exactly and truncates identically: safe. Near-misses aren't.
        risk |= np.isfinite(hp) & (dist > 0) & (dist <= _CMP_TOL * 10)
        risk |= ~np.isfinite(hp)
    if return_margin:
        return risk, margin
    return risk


def compute_overrides(
    tensors: PolicyTensors, values, ts, hot_value, hot_ts, node_valid, now,
    rebase_age: float = 0.0,
):
    """Per-node f64 rescue vectors for the hybrid device step.

    Returns ``(ovr_mask, ovr_sched, ovr_score, n_rescored)``: boolean mask
    of rows whose f32 verdict is at risk of diverging from the Go/f64
    semantics at this ``now``, plus their exact f64 verdicts. The device
    step substitutes these rows, making the f32 fast path bit-identical
    to the f64 oracle everywhere (ref: pkg/plugins/dynamic/stats.go:114-138
    for the semantics being preserved).
    """
    now_f = float(now)
    values64 = np.asarray(values, dtype=np.float64)
    ts64 = np.asarray(ts, dtype=np.float64)
    hot64 = np.asarray(hot_value, dtype=np.float64)
    hot_ts64 = np.asarray(hot_ts, dtype=np.float64)
    valid = np.asarray(node_valid, dtype=bool)
    n = values64.shape[0]
    risk = risk_mask_f64(
        tensors, values64, ts64, hot64, hot_ts64, now_f, rebase_age=rebase_age
    )
    risky = np.nonzero(risk & valid)[0]
    ovr_mask = np.zeros((n,), dtype=bool)
    ovr_sched = np.zeros((n,), dtype=bool)
    ovr_score = np.zeros((n,), dtype=np.int32)
    if len(risky):
        sched64, score64 = score_rows_f64(
            values64[risky], ts64[risky], hot64[risky], hot_ts64[risky],
            now_f, tensors,
        )
        ovr_mask[risky] = True
        ovr_sched[risky] = sched64
        ovr_score[risky] = score64
    return ovr_mask, ovr_sched, ovr_score, len(risky)


# incremental rescan: a cached row is reused only while the clock stays
# within HALF its measured distance-to-boundary — the band tolerances
# drift with `now` at slope <= ~3e-6, so 2x strictly dominates and the
# reused bits are provably identical to a full scan at the new time.
_MARGIN_SAFETY = 0.5


@dataclass
class OverrideCache:
    """Host-side state for the incremental hybrid override refresh.

    Each row's cached scan output (risk bit + f64 rescue verdicts) is
    valid relative to its OWN reference time: rows rescanned at
    different ticks coexist, and a row is reused only while
    ``|now - now_ref| < _MARGIN_SAFETY * margin`` (see
    ``risk_mask_f64(return_margin=True)``) and its inputs are clean.
    """

    mask: np.ndarray  # [N] bool — row carries f64 rescue verdicts
    sched: np.ndarray  # [N] bool
    score: np.ndarray  # [N] int32
    margin: np.ndarray  # [N] f64 distance-to-boundary at now_ref
    now_ref: np.ndarray  # [N] f64 scan time per row
    valid: np.ndarray  # [N] bool node_valid the cache was built for


def compute_overrides_incremental(
    tensors: PolicyTensors, values, ts, hot_value, hot_ts, node_valid, now,
    cache: OverrideCache | None = None,
    dirty_rows=None,
    rebase_age: float = 0.0,
):
    """Incremental twin of ``compute_overrides``.

    Returns ``(ovr_mask, ovr_sched, ovr_score, changed_rows, cache,
    scanned)``: the full override vectors, the row indices whose cached
    entries were recomputed (``None`` after a full scan — everything may
    have changed), the refreshed cache, and the number of rows scanned.

    With a ``cache`` from an earlier call over the SAME array identity
    chain, only rows whose inputs changed (``dirty_rows``) or whose
    clock moved past their margin are rescanned; the rest reuse bits
    that are provably identical to a full ``risk_mask_f64`` +
    ``score_rows_f64`` pass at this ``now``. The returned cache is a
    fresh copy-on-write object — snapshots holding the old cache stay
    self-consistent.
    """
    now_f = float(now)
    values64 = np.asarray(values, dtype=np.float64)
    ts64 = np.asarray(ts, dtype=np.float64)
    hot64 = np.asarray(hot_value, dtype=np.float64)
    hot_ts64 = np.asarray(hot_ts, dtype=np.float64)
    valid = np.asarray(node_valid, dtype=bool)
    n = values64.shape[0]
    if (
        cache is None
        or cache.mask.shape[0] != n
        or not np.array_equal(cache.valid, valid)
    ):
        risk, margin = risk_mask_f64(
            tensors, values64, ts64, hot64, hot_ts64, now_f,
            rebase_age=rebase_age, return_margin=True,
        )
        ovr_mask = np.zeros((n,), dtype=bool)
        ovr_sched = np.zeros((n,), dtype=bool)
        ovr_score = np.zeros((n,), dtype=np.int32)
        risky = np.flatnonzero(risk & valid)
        if risky.size:
            sched64, score64 = score_rows_f64(
                values64[risky], ts64[risky], hot64[risky],
                hot_ts64[risky], now_f, tensors,
            )
            ovr_mask[risky] = True
            ovr_sched[risky] = sched64
            ovr_score[risky] = score64
        cache = OverrideCache(
            mask=ovr_mask,
            sched=ovr_sched,
            score=ovr_score,
            margin=margin,
            now_ref=np.full((n,), now_f),
            valid=valid.copy(),
        )
        return ovr_mask, ovr_sched, ovr_score, None, cache, n

    need = np.abs(now_f - cache.now_ref) >= _MARGIN_SAFETY * cache.margin
    if dirty_rows is not None and len(dirty_rows):
        need[np.asarray(dirty_rows, dtype=np.int64)] = True
    need &= valid
    rows = np.flatnonzero(need)
    if rows.size == 0:
        return cache.mask, cache.sched, cache.score, rows, cache, 0
    risk_r, margin_r = risk_mask_f64(
        tensors, values64[rows], ts64[rows], hot64[rows], hot_ts64[rows],
        now_f, rebase_age=rebase_age, return_margin=True,
    )
    mask_r = np.zeros((rows.size,), dtype=bool)
    sched_r = np.zeros((rows.size,), dtype=bool)
    score_r = np.zeros((rows.size,), dtype=np.int32)
    rr = np.flatnonzero(risk_r)
    if rr.size:
        sub = rows[rr]
        sched64, score64 = score_rows_f64(
            values64[sub], ts64[sub], hot64[sub], hot_ts64[sub], now_f,
            tensors,
        )
        mask_r[rr] = True
        sched_r[rr] = sched64
        score_r[rr] = score64
    # copy-on-write: earlier snapshots keep their own consistent cache
    cache = OverrideCache(
        mask=cache.mask.copy(),
        sched=cache.sched.copy(),
        score=cache.score.copy(),
        margin=cache.margin.copy(),
        now_ref=cache.now_ref.copy(),
        valid=cache.valid,
    )
    cache.mask[rows] = mask_r
    cache.sched[rows] = sched_r
    cache.score[rows] = score_r
    cache.margin[rows] = margin_r
    cache.now_ref[rows] = now_f
    return cache.mask, cache.sched, cache.score, rows, cache, int(rows.size)


class HybridScorer:
    """float32 batched pass + risk mask + exact f64 host re-score.

    ``device=None`` means the GPU (the float32 pass launches the fused
    score kernel); ``device="cpu"`` runs its plain version."""

    def __init__(self, tensors: PolicyTensors, device=None):
        self.tensors = tensors
        self._f32 = BatchedScorer(tensors, dtype=torch.float32, device=device)

    def __call__(self, values, ts, hot_value, hot_ts, node_valid, now) -> HybridResult:
        now_f = float(now)
        values64 = np.asarray(values, dtype=np.float64)
        ts64 = np.asarray(ts, dtype=np.float64)
        hot64 = np.asarray(hot_value, dtype=np.float64)
        hot_ts64 = np.asarray(hot_ts, dtype=np.float64)
        valid = np.asarray(node_valid, dtype=bool)
        # BatchedScorer's f32 mode owns the rebase/downcast invariants
        f32 = self._f32(values64, ts64, hot64, hot_ts64, valid, now_f)
        schedulable = f32.schedulable.cpu().numpy()
        scores = f32.scores.cpu().numpy()
        risk = risk_mask_f64(self.tensors, values64, ts64, hot64, hot_ts64, now_f)
        risky = np.nonzero(risk & valid)[0]
        if len(risky):
            sched64, score64 = score_rows_f64(
                values64[risky], ts64[risky], hot64[risky], hot_ts64[risky],
                now_f, self.tensors,
            )
            schedulable = schedulable.copy()
            scores = scores.copy()
            schedulable[risky] = sched64 & valid[risky]
            scores[risky] = np.where(valid[risky], score64, 0)
        return HybridResult(schedulable, scores, rescored=len(risky))
