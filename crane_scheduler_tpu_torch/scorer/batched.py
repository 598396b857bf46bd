"""Batched filter+score over the node-by-metric load matrix, in PyTorch.

Counterpart of ``crane_scheduler_tpu/scorer/batched.py`` (``BatchedScorer``),
with the same semantics:

    filter:  any_p [ valid(n,p) & thresh_p != 0 & usage(n,p) > thresh_p ]
    score:   clip( trunc(Σ_k s_k / Σ_k w_k) - trunc(hot*10), 0, 100 )
    s_k   =  valid(n,k) ? (1 - usage(n,k)) * w_k * 100 : 0
    valid =  fresh(now < ts + window) & ¬(value < 0) & window > 0

``dtype=torch.float64`` is the parity mode (int64 scores, plain PyTorch
on any device). ``dtype=torch.float32`` is the fast mode with timestamps
rebased around ``now`` (int32 scores); on CUDA tensors it launches the
fused kernel ``csrc/score_kernel.cu`` through ``score_kernel.fused_score``,
and ``score_plain`` below is that kernel's plain version.

Bit-exactness rules (each pinned by the reference): priority entries
accumulate in policy order; Go rounds twice, ``fl(fl((1-u)*w)*100)``, so
every product is its own elementwise op (no fused multiply-add, no
``torch.compile``); the quotient is a true division by a tensor (CUDA
rewrites division by a host scalar as a multiply by its reciprocal); Go
``int()`` maps NaN, ±Inf and out-of-range values to the integer minimum;
``base - penalty`` wraps in two's complement.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..constants import HOT_VALUE_ACTIVE_PERIOD_SECONDS, MAX_NODE_SCORE, MIN_NODE_SCORE
from ..device import resolve_device
from ..policy.compile import PolicyTensors

_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


@dataclass
class ScoreResult:
    schedulable: Any  # [N] bool — Filter verdict (True = passes)
    scores: Any  # [N] int32 in [0, 100] — Score verdict

    def __iter__(self):
        yield self.schedulable
        yield self.scores


class PolicyConstants:
    """A compiled policy's scoring constants in one float dtype.

    ``pred``/``prio`` hold ``(column, threshold-or-weight, window)`` in
    policy order, rounded to the dtype (the plain version slices columns
    with them; the fused kernel takes the same values by value).
    """

    def __init__(self, tensors: PolicyTensors, dtype: torch.dtype, device):
        if dtype not in _DTYPES:
            raise ValueError(f"scorer dtype must be float32 or float64, got {dtype}")
        rnd = _DTYPES[dtype]
        self.dtype = dtype
        self.int_dtype = torch.int64 if dtype == torch.float64 else torch.int32
        self.num_metrics = tensors.num_metrics
        t = tensors
        self.pred = [
            (int(t.pred_idx[p]), float(rnd(t.pred_threshold[p])), float(rnd(t.pred_active[p])))
            for p in range(len(t.pred_idx))
        ]
        self.prio = [
            (int(t.prio_idx[k]), float(rnd(t.prio_weight[k])), float(rnd(t.prio_active[k])))
            for k in range(len(t.prio_idx))
        ]
        self.weight_sum = float(rnd(t.weight_sum))
        self.hot_active = float(rnd(HOT_VALUE_ACTIVE_PERIOD_SECONDS))
        self.device = resolve_device(device)  # resolved, e.g. cuda:0

    def round(self, x: float) -> float:
        """``x`` rounded to the dtype, as a Python float."""
        return float(_DTYPES[self.dtype](x))


def go_trunc(q: torch.Tensor, int_dtype: torch.dtype) -> torch.Tensor:
    """Go ``int(float)``: trunc toward zero; NaN/±Inf/out-of-range give the
    integer minimum (amd64 ``CVTTSD2SI``)."""
    info = torch.iinfo(int_dtype)
    limit = 2.0 ** (info.bits - 1)
    ok = torch.isfinite(q) & (q > -limit) & (q < limit)
    safe = torch.where(ok, torch.trunc(q), 0.0)
    return torch.where(ok, safe.to(int_dtype), info.min)


def score_plain(values, ts, hot_value, hot_ts, node_valid, now: float,
                consts: PolicyConstants):
    """Filter verdicts and scores in plain PyTorch, in ``consts.dtype``:
    the reference ``BatchedScorer._score_impl`` op for op. ``now`` is a
    Python float already rounded to the dtype."""
    n = values.shape[0]
    int_dtype = consts.int_dtype
    over = torch.zeros((n,), dtype=torch.bool, device=values.device)
    for col, threshold, active in consts.pred:
        if not active > 0 or threshold == 0:
            continue  # entry disabled: never overloaded
        u = values[:, col]
        fresh = (ts[:, col] + active) > now  # -inf ts is never fresh
        over |= fresh & ~(u < 0) & (u > threshold)
    schedulable = ~over & node_valid

    if not consts.prio:
        base = torch.zeros((n,), dtype=int_dtype, device=values.device)
    else:
        acc = None
        for col, weight, active in consts.prio:
            u = values[:, col]
            contrib = ((1.0 - u) * weight) * float(MAX_NODE_SCORE)
            if active > 0:
                ok = ((ts[:, col] + active) > now) & ~(u < 0)
                entry = torch.where(ok, contrib, 0.0)
            else:
                entry = torch.zeros_like(contrib)
            acc = entry if acc is None else acc + entry
        # a same-shape divisor keeps the division a true division on CUDA;
        # weight_sum == 0 yields NaN/±Inf, which truncate to the minimum
        base = go_trunc(acc / torch.full_like(acc, consts.weight_sum), int_dtype)

    hot_ok = ((hot_ts + consts.hot_active) > now) & ~(hot_value < 0)
    hv = torch.where(hot_ok, hot_value, 0.0)
    penalty = go_trunc(hv * 10.0, int_dtype)
    score = torch.clamp(base - penalty, MIN_NODE_SCORE, MAX_NODE_SCORE)
    scores = torch.where(node_valid, score.to(torch.int32), 0)
    return schedulable, scores


class BatchedScorer:
    """Filter+score over a load-store snapshot on one device.

    Usage::

        scorer = BatchedScorer(compile_policy(policy), dtype=torch.float32)
        result = scorer(snap.values, snap.ts, snap.hot_value, snap.hot_ts,
                        snap.node_valid, now)
    """

    def __init__(self, tensors: PolicyTensors, dtype=torch.float64, device=None):
        self.tensors = tensors
        self.device = resolve_device(device)
        self.dtype = dtype
        self.consts = PolicyConstants(tensors, dtype, self.device)
        self.int_dtype = self.consts.int_dtype

    def __call__(self, values, ts, hot_value, hot_ts, node_valid, now) -> ScoreResult:
        """Host (numpy) inputs with epoch timestamps; device outputs."""
        np_dtype = _DTYPES[self.dtype]
        if self.dtype != torch.float64:
            # rebase before the downcast: epoch seconds have ~2-minute
            # granularity in float32; (ts - now) is exact in float64
            ts = np.asarray(ts, dtype=np.float64) - float(now)
            hot_ts = np.asarray(hot_ts, dtype=np.float64) - float(now)
            now = 0.0

        def put(a, dt):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(self.device)

        out = self._score_impl(
            put(values, np_dtype),
            put(ts, np_dtype),
            put(hot_value, np_dtype),
            put(hot_ts, np_dtype),
            put(node_valid, bool),
            self.consts.round(float(now)),
        )
        return ScoreResult(*out)

    def _score_impl(self, values, ts, hot_value, hot_ts, node_valid, now: float):
        if self.dtype == torch.float32:
            from .score_kernel import fused_score

            return fused_score(values, ts, hot_value, hot_ts, node_valid, now, self.consts)
        return score_plain(values, ts, hot_value, hot_ts, node_valid, now, self.consts)
